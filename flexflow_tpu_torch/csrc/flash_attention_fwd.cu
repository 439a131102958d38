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
//   f32 at d = 64 and 128 (the wrapper pads any d below 64 to 64) -
//   flash_fwd_wgmma_tf32_kernel below: the same TMA ring and online
//   softmax on the tensor cores, each product in three TF32 passes of
//   split operands (hi . hi + hi . lo + lo . hi), which keeps f32
//   accuracy where one TF32 pass would not; V is transposed in shared
//   memory (TF32 operands are read K-major only) and two warpgroups split
//   the key tiles of a 64-row block. Its header says why.
//
//   bf16 at d = 8, 16, 24 and 32 (the wrapper rounds d up to a multiple of
//   8 below 32) - flash_fwd_wgmma_narrow_kernel below: the same parts on
//   the unpadded tensors, boxes of 16 or 32 columns in the 32- or 64-byte
//   swizzle whose loads zero-fill the columns past d; its header says why.
//
//   bf16 at d = 192 ... 512 (every multiple of 64; the wrapper pads any d
//   from 129 up) - flash_fwd_wgmma_wide_kernel below, built from the same
//   parts: a CTA of two warpgroups owns a block of query rows and all D
//   columns of o: up to d = 320 128 rows, 64 a warpgroup; above, 64 rows
//   with D split between the warpgroups (each contracting half of D for S,
//   the two partial score tiles summed through shared memory, and owning
//   half of o's columns for P.V). Its header says why.
//
//   f32 at d = 192 ... 512 (every multiple of 64; the wrapper pads any d
//   from 129 up) - flash_fwd_wgmma_wide_tf32_kernel below: the f32
//   kernel's three TF32 passes a product and the wide bf16 kernel's split
//   of D between two warpgroups over one block of 64 query rows and all
//   D columns of o, with Q, K and V streamed through the warpgroups' TMA
//   rings in 32-column chunks (Q's TF32 parts split in registers, as the
//   register A operand of S). Its header says why.
//
//   either type above d = 512 (no model has it) - flash_fwd_wide_kernel
//   below: the FMA path with one 64-column chunk of o per CTA (its header
//   says why), d a runtime argument.
//
// Every kernel runs on a 1-D grid (grid_cell in flash_common.cuh), so b*h
// has no 65535 limit; causal launches whose heads' K/V all fit in L2 take
// the heaviest (last) row blocks of all heads first.
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
// scores of this thread's fragment of keys [n0, n0 + 8 * NB); on return it
// holds p_eff, m_i and l_i are updated and alpha is the factor that
// rescales the accumulator. m_i is kept in base-2 units (scores times
// sm_scale * log2(e)).
template <bool DROPOUT, int NB>
__device__ __forceinline__ void online_softmax(
    float (&s)[NB][4], float (&m_i)[2], float (&l_i)[2], float (&alpha)[2],
    int n0, bool edge, const int (&qpos)[2], int tig, int sk, int causal,
    float scale_log2, uint32_t keep, float inv_keep) {
  float mx[2] = {m_i[0], m_i[1]};
  if (edge) {  // scale, mask and take the max in base-2 units
    const float neg_inf2 = NEG_INF * LOG2E;
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
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
    for (int nt = 0; nt < NB; ++nt) {
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
  for (int nt = 0; nt < NB; ++nt) {
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
                           float keep_prob, DropKey seed) {
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
  const GridCell cell = grid_cell((sq + BM - 1) / BM);
  const int m0 = cell.block * BM;
  const int bh = cell.bh;
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
                           float keep_prob, DropKey seed,
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
  dim3 grid;
  if (!launch_grid((sq + Tl::BM - 1) / Tl::BM, bh, 1, causal,
                   2LL * sk * D * sizeof(__nv_bfloat16), &grid))
    return cudaErrorInvalidValue;
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
                         uint32_t threshold, float keep_prob, DropKey seed,
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
// bf16 at d = 192 ... 512: wgmma with two warpgroups per CTA
// ---------------------------------------------------------------------------
// Replaces the TPU kernel _fwd_kernel (flexflow_tpu/kernels/
// flash_attention.py:110) at head dims above 128 in bf16, as the d <= 128
// kernel above does below. Bound at b4 h8 s512: q, k, v read and o written
// once, 33.6 MB at d = 256 (10.04 us at 3.35 TB/s) against 8.6 GFLOP
// (8.69 us at 989 TFLOP/s); 67.1 MB at d = 512 (20.05 us) against 17.2
// GFLOP (17.37 us). Both sides are close, so the kernel has to keep the
// tensor cores busy and read every byte once.
//
// Design. A CTA of two warpgroups owns a block of query rows and ALL D
// columns of its output, so every score of a (query block, key tile) pair,
// its exponential and its softmax bookkeeping are computed once (the wide
// FMA kernel computes them D / 64 times). Measured, 64-row blocks were
// bound by moving K and V from L2 into shared memory once per block (at
// d = 256, 151 MB per call at ~4.4 TB/s; 128-row blocks took it from 34.3
// to 21.1 us, PERF.md sec. 6), not by the tensor cores, so the query
// block is as tall as the registers allow:
//   - d <= 320: 128 rows, each warpgroup owning 64 of them and all D
//     columns (a 64 x D f32 accumulator, up to 160 registers a thread),
//     as the d <= 128 kernel does for 64 rows;
//   - d > 320: the 64 x D accumulator would take D / 2 registers a
//     thread in one warpgroup (256 at D = 512, past the 255 limit), so
//     the two warpgroups split D over one block of 64 rows (WideSplit):
//     each contracts its half of D's 16-deep steps of S = Q . K^T into a
//     partial score tile, the two partials are summed through shared
//     memory (exchange_store / exchange_add), each runs the softmax on
//     the whole tile (the same sums in both, so the same m, l and p: the
//     exponentials are computed twice, the tensor products once), and
//     each multiplies P into its own 64-column blocks of o.
// S is wgmma with both operands K-major in shared memory; P, rounded to
// bf16 in registers, is the A operand of O += P.V with V read MN-major
// through the descriptor's transpose bit; mask, dropout bits and softmax
// are the d <= 128 kernel's. A warpgroup issues the next tile's S before
// it runs this tile's softmax and P.V, so the tensor cores work on
// S(t + 1) while the exponentials of tile t run, and one CTA barrier per
// tile orders the rest. K and V tiles come by TMA into the 128-byte
// swizzle through two-stage mbarrier rings, K released once its S is
// done and V once its P.V is, so every copy is in flight for at least
// one tile's work; Q stays resident. The key tile is 64 keys where two
// stages of K and V fit beside Q (and the exchange buffers) in 227 KB, 32
// otherwise. One CTA per SM (256 threads with up to ~250 registers).

// The wide forward's tiles: WideSplit's rows and D split, with Q resident
// and key tiles of 64 where two stages of K and V fit beside it, else 32.
template <int D>
struct FwdWideTiles : WideSplit<D> {
  using Sp = WideSplit<D>;
  static constexpr int BN = Sp::smem(1, 64) <= SMEM_LIMIT ? 64 : 32;
  static constexpr int NB = BN / 8;  // 8-column blocks of a score tile
  static constexpr int Q_BYTES = Sp::BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr size_t SMEM = Sp::smem(1, BN);
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(WideSplit<D>::THREADS, 1)
    flash_fwd_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_o,
                                float* __restrict__ lse, int sq, int sk,
                                float sm_scale, int causal,
                                uint32_t threshold, float keep_prob,
                                DropKey seed) {
  using Tl = FwdWideTiles<D>;
  constexpr int BM = Tl::BM, BN = Tl::BN, NB = Tl::NB;
  extern __shared__ unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t sQ = (base + SW_ATOM - 1) & ~(uint32_t)(SW_ATOM - 1);
  const uint32_t sKs = sQ + Tl::Q_BYTES;        // K ring
  const uint32_t sVs = sKs + 2 * Tl::KV_BYTES;  // V ring
  float4* xbuf = reinterpret_cast<float4*>(smem + (sVs + 2 * Tl::KV_BYTES -
                                                   base));
  // per stage: the K tile (and, first, Q) landed; the V tile landed
  __shared__ __align__(8) uint64_t k_full[2], v_full[2];

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, wtid = tid % WG_THREADS;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const GridCell cell = grid_cell((sq + BM - 1) / BM);
  const int m0 = cell.block * BM;
  const int bh = cell.bh;
  const int r0 = Tl::row0(wg);            // this warpgroup's rows
  const int row_w = m0 + r0 + warp * 16;  // this warp's first row
  const int qpos[2] = {row_w + g, row_w + g + 8};
  const float scale_log2 = sm_scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;
  // this warpgroup's 16-deep steps of S, and its 64-column blocks of o
  const int kc0 = Tl::kstep0(wg);
  const int b0 = Tl::first_block(wg);
  const int nblk = Tl::blocks(wg);

  int n_tiles = (sk + BN - 1) / BN;
  if (causal)  // a tile is live iff its first key is visible to the last row
    n_tiles = min(n_tiles, (m0 + BM - 1) / BN + 1);

  auto k_stage = [&](int t) { return sKs + (t & 1) * Tl::KV_BYTES; };
  auto v_stage = [&](int t) { return sVs + (t & 1) * Tl::KV_BYTES; };
  auto k_bar = [&](int t) { return smem_u32(&k_full[t & 1]); };
  auto v_bar = [&](int t) { return smem_u32(&v_full[t & 1]); };
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load_k = [&](int t, int extra_bytes) {  // by thread 0
    mbar_expect_tx(k_bar(t), Tl::KV_BYTES + extra_bytes);
    tma_load_tile<BN, D>(k_stage(t), map_k, k_bar(t), t * BN, bh);
  };
  auto load_v = [&](int t) {  // by thread 0
    mbar_expect_tx(v_bar(t), Tl::KV_BYTES);
    tma_load_tile<BN, D>(v_stage(t), map_v, v_bar(t), t * BN, bh);
  };
  // this warpgroup's S of tile t (partial, over its half of D, when the
  // warpgroups split D), one commit group
  auto issue_s = [&](int t, float (&s)[NB][4]) {
    const uint32_t sK = k_stage(t);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < Tl::KSTEPS; ++i) {
      const int kc = kc0 + i;
      const uint32_t a = sQ + (kc >> 2) * (BM * SW_ROW) + r0 * SW_ROW +
                         (kc & 3) * 32;
      const uint32_t b = sK + (kc >> 2) * (BN * SW_ROW) + (kc & 3) * 32;
      wgmma_ss_kk<NB>(s, desc_sw128(a, 16), desc_sw128(b, 16), i > 0);
    }
    wgmma_commit();
  };
  // the exchange buffer of tile t: two, by parity, so a warpgroup stores
  // tile t + 1's partial while the other may still read tile t's
  auto xbuf_of = [&](int t) { return xbuf + (t & 1) * (2 * NB * WG_THREADS); };

  // The ring. K and V are released at different times: K tile t once
  // S(t) is done (the exchange barrier that ends iteration t - 1), V tile
  // t once P.V(t) is done (the barrier that ends iteration t). So the
  // barrier that ends iteration t starts the copies of K tile t + 3 and V
  // tile t + 2, and each K tile is in flight for a whole iteration before
  // its S is issued. First: Q with K tile 0, V tile 0, K and V tile 1.
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
    load_k(0, Tl::Q_BYTES);  // Q joins K tile 0's phase
    tma_load_tile<BM, D>(sQ, &tm_q, k_bar(0), m0, bh);
    load_v(0);
    if (n_tiles > 1) {
      load_k(1, 0);
      load_v(1);
    }
  }

  float acc[Tl::MAX_BLOCKS * 8][4];  // this warpgroup's part of o
#pragma unroll
  for (int dt = 0; dt < Tl::MAX_BLOCKS * 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_i[2] = {NEG_INF * LOG2E, NEG_INF * LOG2E};  // base 2
  float l_i[2] = {0.f, 0.f};  // this thread's partial row sums

  // S(0) (split D: the sum of the two warpgroups' partials, in both)
  float s[NB][4];
  mbar_wait(k_bar(0), 0);  // K tile 0 and Q have landed
  issue_s(0, s);
  wgmma_wait<0>();
  fence_acc(s);
  if (!Tl::ROW_SPLIT) exchange_store(xbuf_of(0), wg, wtid, s);
  __syncthreads();
  if (!Tl::ROW_SPLIT) exchange_add(xbuf_of(0), wg, wtid, s);
  if (tid == 0 && n_tiles > 2) load_k(2, 0);  // K tile 0 is free

  // Iteration t issues S(t + 1) on the tensor cores, then runs the softmax
  // of tile t and issues P.V(t) while it runs; the partials of S(t + 1)
  // are exchanged at its end.
  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BN;
    const bool more = t + 1 < n_tiles;
    float s_next[NB][4];
    if (more) {
      mbar_wait(k_bar(t + 1), ((t + 1) >> 1) & 1);  // K tile t + 1 landed
      issue_s(t + 1, s_next);
    }
    const uint32_t keep =  // the dropout mask of tile t
        DROPOUT ? keep_bits<NB>(n0, qpos, tig, bh, seed, threshold) : 0u;
    const bool edge = n0 + BN > sk || (causal && n0 + BN - 1 > row_w);
    float alpha[2];
    online_softmax<DROPOUT>(s, m_i, l_i, alpha, n0, edge, qpos, tig, sk,
                            causal, scale_log2, keep, inv_keep);
#pragma unroll
    for (int dt = 0; dt < Tl::MAX_BLOCKS * 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    uint32_t pa[NB / 2][4];
    to_a_frags(s, pa);  // p_eff rounded to bf16

    // O[:, own blocks] += P . V[:, own blocks]: P in registers, V MN-major
    const uint32_t sV = v_stage(t);
    mbar_wait(v_bar(t), (t >> 1) & 1);  // V tile t has landed
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < Tl::MAX_BLOCKS; ++h) {
      if (h < nblk) {
#pragma unroll
        for (int kc = 0; kc < NB / 2; ++kc) {
          const uint32_t b = sV + (b0 + h) * (BN * SW_ROW) + kc * 2 * SW_ATOM;
          wgmma_rs_m64n64k16<1>(acc_block(acc, h), pa[kc],
                                desc_sw128(b, BN * SW_ROW), 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();  // S(t + 1) and P.V(t)
    fence_regs_u32(pa);
#pragma unroll
    for (int h = 0; h < Tl::MAX_BLOCKS; ++h) fence_regs(acc_block(acc, h));
    if (more) {
      fence_acc(s_next);
      if (!Tl::ROW_SPLIT) exchange_store(xbuf_of(t + 1), wg, wtid, s_next);
    }
    __syncthreads();  // (split D: both partials of S(t + 1) stored) every
                      // warpgroup done with K tile t + 1 and V tile t
    if (more) {
      if (!Tl::ROW_SPLIT) exchange_add(xbuf_of(t + 1), wg, wtid, s_next);
#pragma unroll
      for (int nt = 0; nt < NB; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = s_next[nt][c];
    }
    if (tid == 0) {
      if (t + 3 < n_tiles) load_k(t + 3, 0);
      if (t + 2 < n_tiles) load_v(t + 2);
    }
  }

  // o = acc / l, each warpgroup's blocks staged in bf16 in Q's tile (no
  // warpgroup reads Q after the barrier that completes the last S) in the
  // swizzled layout and stored by one TMA copy, which clips rows past sq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = (l == 0.f) ? 1.f : l;
    const float inv_l = 1.f / l_safe;
    const int row = r0 + warp * 16 + g + 8 * r;  // in the tile
#pragma unroll
    for (int h = 0; h < Tl::MAX_BLOCKS; ++h) {
      if (h < nblk) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int dt = h * 8 + j;
          __nv_bfloat162 v2 = __floats2bfloat162_rn(acc[dt][2 * r] * inv_l,
                                                    acc[dt][2 * r + 1] * inv_l);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           sQ + sw128_offset<BM>(row, (b0 + h) * 8 + j) +
                           tig * 4),
                       "r"(*reinterpret_cast<uint32_t*>(&v2))
                       : "memory");
        }
      }
    }
    if ((Tl::ROW_SPLIT || wg == 0) && tig == 0 && qpos[r] < sq)
      lse[(size_t)bh * sq + qpos[r]] = m_i[r] * LN2 + logf(l_safe);
  }
  fence_proxy_async();  // the staged tile, visible to the TMA store
  __syncthreads();
  if (tid == 0) {
    tma_store_tile<BM, D>(&tm_o, sQ, m0, bh);
    tma_store_wait();  // the CTA's shared memory outlives the copy
  }
}

template <int D, bool DROPOUT>
cudaError_t launch_wgmma_wide_t(const void* q, const void* k, const void* v,
                                void* o, void* lse, int bh, int sq, int sk,
                                int causal, float sm_scale,
                                uint32_t threshold, float keep_prob,
                                DropKey seed, cudaStream_t stream) {
  using Tl = FwdWideTiles<D>;
  auto kernel = flash_fwd_wgmma_wide_kernel<D, DROPOUT>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, Tl::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if ((err = tensor_map_bf16(&tm_q, q, bh, sq, D, Tl::BM)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_k, k, bh, sk, D, Tl::BN)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_v, v, bh, sk, D, Tl::BN)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_o, o, bh, sq, D, Tl::BM)) != cudaSuccess)
    return err;
  dim3 grid;
  if (!launch_grid((sq + Tl::BM - 1) / Tl::BM, bh, 1, causal,
                   2LL * sk * D * sizeof(__nv_bfloat16), &grid))
    return cudaErrorInvalidValue;
  kernel<<<grid, WideSplit<D>::THREADS, Tl::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<float*>(lse), sq, sk, sm_scale,
      causal, threshold, keep_prob, seed);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma_wide(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int sq, int sk,
                              int causal, float sm_scale, int use_dropout,
                              uint32_t threshold, float keep_prob,
                              DropKey seed, cudaStream_t stream) {
  return use_dropout
             ? launch_wgmma_wide_t<D, true>(q, k, v, o, lse, bh, sq, sk,
                                            causal, sm_scale, threshold,
                                            keep_prob, seed, stream)
             : launch_wgmma_wide_t<D, false>(q, k, v, o, lse, bh, sq, sk,
                                             causal, sm_scale, threshold,
                                             keep_prob, seed, stream);
}

// ---------------------------------------------------------------------------
// bf16 at d <= 32: the narrow wgmma kernel
// ---------------------------------------------------------------------------
// Replaces the TPU kernel _fwd_kernel (flexflow_tpu/kernels/
// flash_attention.py:110) at head dims up to 32 in bf16 (the Transformer's
// heads of d = 8), as the d <= 128 kernel above does at 64 and 128. The
// reference pads d to 64; run so, the d = 64 kernel spends 8x the tensor
// work and 8x the K/V bytes on zero columns at d = 8, after three host
// pads. Bound at b64 h8 s512 d8: 17.8 MB of q, k, v, o and lse (5.3 us
// at 3.35 TB/s) and 0.5 GFLOP, but 134 M exponentials, one MUFU ex2 each
// at 16 per SM per clock (~34 us at 1.98 GHz), with an FFMA, an FADD, an
// FMNMX and half a conversion to bf16 beside each on the FP32 pipes: the
// softmax is the work, not the products or the bytes.
//
// Design. The tensor maps cover the true (bh, s, d) tensors with boxes of
// DP = d rounded up to 16 or 32 columns, rows of 32 or 64 bytes in the 32-
// or 64-byte swizzle: a load zero-fills the columns past d in shared
// memory and the store of o clips them, so nothing is padded on the host.
// S = Q . K^T is one (DP = 16) or two (DP = 32) k16 wgmma steps per 64
// keys, both operands K-major; P, rounded to bf16 in registers, is the A
// operand of O += P . V, m64nDPk16 with V MN-major. A CTA is one
// warpgroup of 64 query rows over K/V tiles of 64 keys, which come by TMA
// through rings of two stages, K released once its S is done and V once
// its P . V is (the wide kernel's ring); the warpgroup issues the next
// tile's S before this tile's softmax, so the tensor cores and the loads
// run under the exponentials, and four CTAs share an SM (at most 128
// registers a thread), so one CTA's exponentials run while another waits.
// On the H100 at b64 h8 s512 d8 that beat two warpgroups sharing each K/V
// tile, key tiles of 128 and deeper rings (PERF.md sec. 6): a K/V tile is
// 2 KB at d = 8, so sharing it saves little, and what counts is enough
// warps in flight to keep the special-function units busy. Mask, dropout
// bits (keep_bits), the base-2 softmax and the epilogue are the other
// bf16 kernels'.
template <int DP>
struct NarrowTiles {
  static_assert(DP == 16 || DP == 32, "16 or 32 columns");
  static constexpr int BM = WG_ROWS;    // query rows per CTA
  static constexpr int BN = 64;         // keys per K/V tile
  static constexpr int NB = BN / 8;     // 8-column blocks of S
  static constexpr int ROW = DP * 2;    // bytes of a tile row
  static constexpr int ATOM = 8 * ROW;  // an 8-row swizzle atom
  static constexpr uint32_t MODE = DP == 16 ? 3 : 2;  // 32- or 64-byte
  static constexpr int Q_BYTES = BM * ROW;
  static constexpr int KV_BYTES = BN * ROW;
  // Q, then rings of two stages (the tile in use, the one in flight) for
  // K and for V
  static constexpr size_t SMEM = SW_ATOM + Q_BYTES + 4 * KV_BYTES;
};

template <int DP, bool DROPOUT>
__global__ void __launch_bounds__(WG_THREADS, 4)
    flash_fwd_wgmma_narrow_kernel(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  const __grid_constant__ CUtensorMap tm_o,
                                  float* __restrict__ lse, int sq, int sk,
                                  float sm_scale, int causal,
                                  uint32_t threshold, float keep_prob,
                                  DropKey seed) {
  using Tl = NarrowTiles<DP>;
  constexpr int BM = Tl::BM, BN = Tl::BN, NB = Tl::NB;
  constexpr int ROW = Tl::ROW, ATOM = Tl::ATOM;
  extern __shared__ unsigned char smem[];
  const uint32_t sQ = (smem_u32(smem) + SW_ATOM - 1) & ~(uint32_t)(SW_ATOM - 1);
  const uint32_t sKs = sQ + Tl::Q_BYTES;        // K ring
  const uint32_t sVs = sKs + 2 * Tl::KV_BYTES;  // V ring
  // per stage: the K tile (and, first, Q) landed; the V tile landed
  __shared__ __align__(8) uint64_t k_full[2], v_full[2];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const GridCell cell = grid_cell((sq + BM - 1) / BM);
  const int m0 = cell.block * BM;
  const int bh = cell.bh;
  const int row_w = m0 + warp * 16;  // this warp's first row
  const int qpos[2] = {row_w + g, row_w + g + 8};
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
  auto load_k = [&](int t, int extra_bytes) {  // by thread 0
    mbar_expect_tx(k_bar(t), Tl::KV_BYTES + extra_bytes);
    tma_load_3d(k_stage(t), map_k, k_bar(t), 0, t * BN, bh);
  };
  auto load_v = [&](int t) {  // by thread 0
    mbar_expect_tx(v_bar(t), Tl::KV_BYTES);
    tma_load_3d(v_stage(t), map_v, v_bar(t), 0, t * BN, bh);
  };
  // S of tile t, one commit group: DP / 16 steps of m64n64k16
  auto issue_s = [&](int t, float (&s)[NB][4]) {
    const uint32_t sK = k_stage(t);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc)
      wgmma_ss_m64n64k16(acc_block(s, 0),
                         desc_sw(sQ + kc * 32, 16, ATOM, Tl::MODE),
                         desc_sw(sK + kc * 32, 16, ATOM, Tl::MODE), kc > 0);
    wgmma_commit();
  };

  // The ring (the wide kernel's): K tile t is released once S(t) is done,
  // V tile t once P.V(t) is, so the barrier that ends iteration t starts
  // the copies of K tile t + 3 and V tile t + 2. First: Q with K tile 0, V
  // tile 0, K and V tile 1.
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
    load_k(0, Tl::Q_BYTES);  // Q joins K tile 0's phase
    tma_load_3d(sQ, &tm_q, k_bar(0), 0, m0, bh);
    load_v(0);
    if (n_tiles > 1) {
      load_k(1, 0);
      load_v(1);
    }
  }

  float acc[DP / 8][4];  // the 64 x DP of o
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_i[2] = {NEG_INF * LOG2E, NEG_INF * LOG2E};  // base 2
  float l_i[2] = {0.f, 0.f};  // this thread's partial row sums

  float s[NB][4];
  mbar_wait(k_bar(0), 0);  // K tile 0 and Q have landed
  issue_s(0, s);
  wgmma_wait<0>();
  fence_acc(s);
  __syncthreads();  // every warp's S(0) is done: K tile 0 is free
  if (tid == 0 && n_tiles > 2) load_k(2, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BN;
    const bool more = t + 1 < n_tiles;
    float s_next[NB][4];
    if (more) {
      mbar_wait(k_bar(t + 1), ((t + 1) >> 1) & 1);  // K tile t + 1 landed
      issue_s(t + 1, s_next);
    }
    const uint32_t keep =  // the dropout mask of tile t
        DROPOUT ? keep_bits(n0, qpos, tig, bh, seed, threshold) : 0u;
    const bool edge = n0 + BN > sk || (causal && n0 + BN - 1 > row_w);
    float alpha[2];
    online_softmax<DROPOUT>(s, m_i, l_i, alpha, n0, edge, qpos, tig, sk,
                            causal, scale_log2, keep, inv_keep);
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    uint32_t pa[NB / 2][4];
    to_a_frags(s, pa);  // p_eff rounded to bf16

    // O += P . V: P in registers, V MN-major, 16 keys a step
    const uint32_t sV = v_stage(t);
    mbar_wait(v_bar(t), (t >> 1) & 1);  // V tile t has landed
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < NB / 2; ++kc)
      wgmma_rs_kk<DP / 8, 1>(
          acc, pa[kc],
          desc_sw(sV + kc * 16 * ROW, Tl::KV_BYTES, ATOM, Tl::MODE), 1);
    wgmma_commit();
    wgmma_wait<0>();  // S(t + 1) and P.V(t)
    fence_regs_u32(pa);
    fence_acc(acc);
    if (more) fence_acc(s_next);
    __syncthreads();  // every warp done with K tile t + 1 and V tile t
    if (more) {
#pragma unroll
      for (int nt = 0; nt < NB; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = s_next[nt][c];
    }
    if (tid == 0) {
      if (t + 3 < n_tiles) load_k(t + 3, 0);
      if (t + 2 < n_tiles) load_v(t + 2);
    }
  }

  // o = acc / l, staged in bf16 in Q's tile (no warp reads Q after the
  // barrier that completes the last S) in the swizzled layout and stored
  // by one TMA copy, which clips the rows past sq and the columns past d
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = (l == 0.f) ? 1.f : l;
    const float inv_l = 1.f / l_safe;
    const int row = warp * 16 + g + 8 * r;  // in the tile
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      __nv_bfloat162 v2 = __floats2bfloat162_rn(acc[dt][2 * r] * inv_l,
                                                acc[dt][2 * r + 1] * inv_l);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       sQ + sw_offset<ROW>(row, dt) + tig * 4),
                   "r"(*reinterpret_cast<uint32_t*>(&v2))
                   : "memory");
    }
    if (tig == 0 && qpos[r] < sq)
      lse[(size_t)bh * sq + qpos[r]] = m_i[r] * LN2 + logf(l_safe);
  }
  fence_proxy_async();  // the staged tile, visible to the TMA store
  __syncthreads();
  if (tid == 0) {
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
        " [%0, {%2, %3, %4}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(&tm_o)),
        "r"(sQ), "r"(0), "r"(m0), "r"(bh)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    tma_store_wait();  // the CTA's shared memory outlives the copy
  }
}

template <int DP, bool DROPOUT>
cudaError_t launch_narrow_t(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int sq, int sk, int d,
                            int causal, float sm_scale, uint32_t threshold,
                            float keep_prob, DropKey seed,
                            cudaStream_t stream) {
  using Tl = NarrowTiles<DP>;
  auto kernel = flash_fwd_wgmma_narrow_kernel<DP, DROPOUT>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, Tl::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  const CUtensorMapSwizzle swz =
      DP == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if ((err = tensor_map_bf16(&tm_q, q, bh, sq, d, Tl::BM, DP, swz)) !=
          cudaSuccess ||
      (err = tensor_map_bf16(&tm_k, k, bh, sk, d, Tl::BN, DP, swz)) !=
          cudaSuccess ||
      (err = tensor_map_bf16(&tm_v, v, bh, sk, d, Tl::BN, DP, swz)) !=
          cudaSuccess ||
      (err = tensor_map_bf16(&tm_o, o, bh, sq, d, Tl::BM, DP, swz)) !=
          cudaSuccess)
    return err;
  dim3 grid;
  if (!launch_grid((sq + Tl::BM - 1) / Tl::BM, bh, 1, causal,
                   2LL * sk * d * sizeof(__nv_bfloat16), &grid))
    return cudaErrorInvalidValue;
  kernel<<<grid, WG_THREADS, Tl::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<float*>(lse), sq, sk, sm_scale,
      causal, threshold, keep_prob, seed);
  return cudaGetLastError();
}

// DP: d rounded up to 16 or 32 (d a multiple of 8, TMA's 16-byte rows)
template <int DP>
cudaError_t launch_narrow(const void* q, const void* k, const void* v,
                          void* o, void* lse, int bh, int sq, int sk, int d,
                          int causal, float sm_scale, int use_dropout,
                          uint32_t threshold, float keep_prob, DropKey seed,
                          cudaStream_t stream) {
  return use_dropout
             ? launch_narrow_t<DP, true>(
                   q, k, v, o, lse, bh, sq, sk, d, causal, sm_scale,
                   threshold, keep_prob, seed, stream)
             : launch_narrow_t<DP, false>(
                   q, k, v, o, lse, bh, sq, sk, d, causal, sm_scale,
                   threshold, keep_prob, seed, stream);
}

// ---------------------------------------------------------------------------
// f32 at d = 64 and 128: split-precision TF32 wgmma with a TMA tile ring
// ---------------------------------------------------------------------------
// Replaces the TPU kernel _fwd_kernel (flexflow_tpu/kernels/
// flash_attention.py:110) for f32 at d <= 128, where PR 1's FMA kernel ran
// until this one: the kernel of the search's calibration rows (b1 h8 d64
// causal at s 128 and 512, op_attention@flash). It computes what that
// kernel computed, to f32 accuracy, on the tensor cores.
//
// Bound at b1 h8 d64 causal: q, k, v read and o written once, 1.05 MB at
// s128 (0.31 us at 3.35 TB/s) and 4.2 MB at s512 (1.25 us), against three
// TF32 passes of 4 * d flops per kept (query, key) pair at 495 TFLOP/s
// (0.10 us at s128, 1.63 us at s512: operations). The same work at the
// f32 FMA rate of 67 TFLOP/s would take 0.27 / 4.01 us.
//
// Design. The FMA kernel was held back by four things, each answered here:
//   - no tensor cores (two FMAs per shared load): every product is wgmma
//     m64nNk8 .tf32 in three passes, a_lo . b_hi + a_hi . b_lo, then a_hi .
//     b_hi, each operand split as tf32_split (hopper_common.cuh) makes it:
//     hi = x with its low 13 mantissa bits cleared, lo = x - hi cleared
//     the same way. One TF32 pass keeps ~3 decimal digits; three keep the
//     products to ~2^-20, inside the f32 tolerance of the plain version;
//   - no copy in flight: K and V tiles come by TMA through a ring of two
//     stages on mbarriers (K and V on separate ones, so S starts before V
//     has landed), and the copy of tile t + 2 is issued as soon as tile t
//     has been drained (its K split and read by S, its V transposed);
//   - a starved grid (b1 h8: 16 CTAs of 64 rows at s128, 64 at s512, on
//     132 SMs; the causal diagonal makes the last row block the critical
//     path): two consumer warpgroups per CTA split the key tiles of one
//     64-row block (warpgroup w takes tiles w, w + 2, ...; ring stage w is
//     its own) and merge (m, l, acc) through shared memory at the end, so
//     the heaviest block crosses half its tiles per warpgroup (one
//     warpgroup alone was 16-33% slower at s 512 ... 4096 and at d = 128,
//     and no faster at s 128, PERF.md sec. 6; with one key tile the
//     second warpgroup idles);
//   - a spill: the accumulator (32 / 64 registers at d = 64 / 128), S (32
//     / 16) and P's hi and lo A fragments stay in registers, Q hi and lo
//     stay in shared memory, and a CTA is two warpgroups, one CTA an SM
//     (up to 255 registers a thread).
// Operand layouts. TF32 wgmma reads its shared operands K-major only, so
// the descriptor's transpose bit that the bf16 kernel uses for V does not
// exist: S = Q . K^T reads Q and K as TMA lands them (an f32 row of d = 64
// is two 128-byte swizzle atoms, like a bf16 row of d = 128), and the
// warpgroup transposes each V tile into V^T hi and lo tiles (keys
// contiguous) while S runs (split_transpose_v). P is the register A
// operand: a TF32 A slice holds keys (tig, tig + 4) of its 8 where S's
// accumulator holds (2 tig, 2 tig + 1), so V^T stores each 8-key group in
// the order (0, 2, 4, 6, 1, 3, 5, 7) and the accumulator becomes A
// fragments in place (tf32_a_frags); masks and dropout bits are taken in
// the accumulator's frame, at the true key positions. Shared memory: Q hi
// and lo, two stages of K and V, and per warpgroup K lo, V^T hi and V^T lo;
// at d = 128 the key tiles are 32 deep to fit (230 KB with two
// warpgroups). The softmax is the bf16 kernel's (online_softmax, base 2).
template <int D>
struct Tf32Tiles {
  static constexpr int NWG = 2;                 // warpgroups per CTA
  static constexpr int BM = WG_ROWS;            // query rows per CTA
  static constexpr int BN = D == 64 ? 64 : 32;  // keys per K/V tile
  static constexpr int NB = BN / 8;             // 8-key blocks of a tile
  static constexpr int THREADS = NWG * WG_THREADS;
  static constexpr int Q_BYTES = BM * D * 4;
  static constexpr int KV_BYTES = BN * D * 4;  // a K, V, K lo or V^T tile
  // Q hi and lo; two ring stages of K and V; per warpgroup K lo, V^T hi
  // and V^T lo
  static constexpr size_t SMEM = SW_ATOM + 2 * (size_t)Q_BYTES +
                                 (4 + 3 * NWG) * (size_t)KV_BYTES;
  static_assert(D == 64 || D == 128, "d = 64 or 128");
  static_assert(SMEM <= SMEM_LIMIT, "fits one CTA");
};

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(Tf32Tiles<D>::THREADS, 1)
    flash_fwd_wgmma_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_o,
                                float* __restrict__ lse, int sq, int sk,
                                float sm_scale, int causal,
                                uint32_t threshold, float keep_prob,
                                DropKey seed) {
  using Tl = Tf32Tiles<D>;
  constexpr int BM = Tl::BM, BN = Tl::BN, NB = Tl::NB, KVB = Tl::KV_BYTES;
  constexpr int NWG = Tl::NWG;
  extern __shared__ unsigned char smem[];
  const uint32_t sQ = (smem_u32(smem) + SW_ATOM - 1) & ~(uint32_t)(SW_ATOM - 1);
  const uint32_t sQlo = sQ + Tl::Q_BYTES;
  const uint32_t sRing = sQlo + Tl::Q_BYTES;  // stage st: K, then V
  // Q landed; per stage, the K tile and the V tile landed
  __shared__ __align__(8) uint64_t q_full, k_full[2], v_full[2];

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, wtid = tid % WG_THREADS;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const GridCell cell = grid_cell((sq + BM - 1) / BM);
  const int m0 = cell.block * BM;
  const int bh = cell.bh;
  const int row_w = m0 + warp * 16;  // this warp's first row
  const int qpos[2] = {row_w + g, row_w + g + 8};
  const float scale_log2 = sm_scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;
  // this warpgroup's K lo, V^T hi and V^T lo
  const uint32_t sKlo = sRing + (4 + 3 * wg) * KVB;
  const uint32_t sVhi = sKlo + KVB, sVlo = sVhi + KVB;

  int n_tiles = (sk + BN - 1) / BN;
  if (causal)  // a tile is live iff its first key is visible to the last row
    n_tiles = min(n_tiles, (m0 + BM - 1) / BN + 1);

  auto k_stage = [&](int t) { return sRing + (t & 1) * 2 * KVB; };
  auto k_bar = [&](int t) { return smem_u32(&k_full[t & 1]); };
  auto v_bar = [&](int t) { return smem_u32(&v_full[t & 1]); };
  const uint32_t q_bar = smem_u32(&q_full);
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load_kv = [&](int t) {  // by one thread
    mbar_expect_tx(k_bar(t), KVB);
    tma_load_tile<BN, D, 32>(k_stage(t), map_k, k_bar(t), t * BN, bh);
    mbar_expect_tx(v_bar(t), KVB);
    tma_load_tile<BN, D, 32>(k_stage(t) + KVB, map_v, v_bar(t), t * BN, bh);
  };

  if (tid == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mbar_init(k_bar(st), 1);
      mbar_init(v_bar(st), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, Tl::Q_BYTES);
    tma_load_tile<BM, D, 32>(sQ, &tm_q, q_bar, m0, bh);
    for (int t = 0; t < min(2, n_tiles); ++t) load_kv(t);
  }
  // Q split into hi (in place) and lo by every thread
  mbar_wait(q_bar, 0);
  split_tile_tf32<Tl::Q_BYTES, Tl::THREADS>(sQ, sQlo, tid);
  fence_proxy_async();
  __syncthreads();

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_i[2] = {NEG_INF * LOG2E, NEG_INF * LOG2E};  // running max, base 2
  float l_i[2] = {0.f, 0.f};  // this thread's partial row sums

  for (int t = wg; t < n_tiles; t += NWG) {
    const int n0 = t * BN;
    const uint32_t sK = k_stage(t), sV = sK + KVB;
    const uint32_t phase = (t >> 1) & 1;
    mbar_wait(k_bar(t), phase);  // K tile t has landed
    split_tile_tf32<KVB, WG_THREADS>(sK, sKlo, wtid);
    fence_proxy_async();
    named_barrier(1 + wg, WG_THREADS);  // K hi and lo, visible to wgmma

    // S = Q . K^T in three passes, the two small ones first
    float s[NB][4];
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
      const uint32_t qa = pass == 0 ? sQlo : sQ;
      const uint32_t kb = pass == 1 ? sKlo : sK;
#pragma unroll
      for (int kc = 0; kc < D / 8; ++kc) {
        const uint32_t a = qa + (kc >> 2) * (BM * SW_ROW) + (kc & 3) * 32;
        const uint32_t b = kb + (kc >> 2) * (BN * SW_ROW) + (kc & 3) * 32;
        wgmma_ss_kk_tf32(s, desc_sw128(a, 16), desc_sw128(b, 16),
                         pass + kc > 0);
      }
    }
    wgmma_commit();
    // while S runs: the dropout mask, then V^T hi and lo
    const uint32_t keep =
        DROPOUT ? keep_bits<NB>(n0, qpos, tig, bh, seed, threshold) : 0u;
    mbar_wait(v_bar(t), phase);  // V tile t has landed
    split_transpose_v<D, BN>(sV, sVhi, sVlo, wtid);
    fence_proxy_async();
    wgmma_wait<0>();
    fence_acc(s);
    // the stage is drained (K read by S, V transposed) and V^T is visible:
    // the stage takes tile t + 2, this warpgroup's next
    named_barrier(1 + wg, WG_THREADS);
    if (wtid == 0 && t + 2 < n_tiles) load_kv(t + 2);

    const bool edge = n0 + BN > sk || (causal && n0 + BN - 1 > row_w);
    float alpha[2];
    online_softmax<DROPOUT>(s, m_i, l_i, alpha, n0, edge, qpos, tig, sk,
                            causal, scale_log2, keep, inv_keep);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    // O += P . V in three passes: P hi and lo in registers, V^T hi and lo
    uint32_t ph[NB][4], pl[NB][4];
    tf32_a_frags(s, ph, pl);
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
      const uint32_t vb = pass == 1 ? sVlo : sVhi;
#pragma unroll
      for (int kc = 0; kc < NB; ++kc) {
        const uint32_t b = vb + (kc >> 2) * (D * SW_ROW) + (kc & 3) * 32;
        wgmma_rs_kk_tf32(acc, pass == 0 ? pl[kc] : ph[kc],
                         desc_sw128(b, 16));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs_u32(ph);
    fence_regs_u32(pl);
    fence_regs(*reinterpret_cast<float(*)[D / 2]>(&acc[0][0]));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
  {
    // warpgroup 1 hands (m, l, acc) to warpgroup 0 through its own K lo
    // buffer (one float4 per thread and 8 columns, consecutive threads on
    // consecutive 16 bytes); warpgroup 0 merges them into its own (a
    // warpgroup that had no tile holds m = -inf, l = 0, acc = 0)
    const uint32_t xb = sRing + 7 * KVB;
    static_assert((D / 8 + 1) * WG_THREADS * 16 <= 3 * KVB, "room");
    if (wg == 1) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        st_shared_f4(xb + (dt * WG_THREADS + wtid) * 16, acc[dt][0],
                     acc[dt][1], acc[dt][2], acc[dt][3]);
      st_shared_f4(xb + (D / 8 * WG_THREADS + wtid) * 16, m_i[0], m_i[1],
                   l_i[0], l_i[1]);
    }
    __syncthreads();
    if (wg == 0) {
      const float4 ml = ld_shared_f4(xb + (D / 8 * WG_THREADS + wtid) * 16);
      const float mo[2] = {ml.x, ml.y}, lo[2] = {ml.z, ml.w};
      float fa[2], fb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = fmaxf(m_i[r], mo[r]);
        fa[r] = exp2_approx(m_i[r] - m);
        fb[r] = exp2_approx(mo[r] - m);
        l_i[r] = l_i[r] * fa[r] + lo[r] * fb[r];
        m_i[r] = m;
      }
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const float4 x = ld_shared_f4(xb + (dt * WG_THREADS + wtid) * 16);
        acc[dt][0] = acc[dt][0] * fa[0] + x.x * fb[0];
        acc[dt][1] = acc[dt][1] * fa[0] + x.y * fb[0];
        acc[dt][2] = acc[dt][2] * fa[1] + x.z * fb[1];
        acc[dt][3] = acc[dt][3] * fa[1] + x.w * fb[1];
      }
    }
  }

  // o = acc / l, staged in Q's hi tile (no longer read) in the swizzled
  // layout and stored by one TMA copy, which clips rows past sq
  if (wg == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l_safe = (l_i[r] == 0.f) ? 1.f : l_i[r];
      const float inv_l = 1.f / l_safe;
      const int row = warp * 16 + g + 8 * r;  // in the tile
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         sQ + sw128_offset<BM>(row, 2 * dt + (tig >> 1)) +
                         (tig & 1) * 8),
                     "f"(acc[dt][2 * r] * inv_l),
                     "f"(acc[dt][2 * r + 1] * inv_l)
                     : "memory");
      if (tig == 0 && qpos[r] < sq)
        lse[(size_t)bh * sq + qpos[r]] = m_i[r] * LN2 + logf(l_safe);
    }
  }
  fence_proxy_async();  // the staged tile, visible to the TMA store
  __syncthreads();
  if (tid == 0) {
    tma_store_tile<BM, D, 32>(&tm_o, sQ, m0, bh);
    tma_store_wait();  // the CTA's shared memory outlives the copy
  }
}

template <int D, bool DROPOUT>
cudaError_t launch_tf32_t(const void* q, const void* k, const void* v,
                          void* o, void* lse, int bh, int sq, int sk,
                          int causal, float sm_scale, uint32_t threshold,
                          float keep_prob, DropKey seed,
                          cudaStream_t stream) {
  using Tl = Tf32Tiles<D>;
  auto kernel = flash_fwd_wgmma_tf32_kernel<D, DROPOUT>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, Tl::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if ((err = tensor_map_f32(&tm_q, q, bh, sq, D, Tl::BM)) != cudaSuccess ||
      (err = tensor_map_f32(&tm_k, k, bh, sk, D, Tl::BN)) != cudaSuccess ||
      (err = tensor_map_f32(&tm_v, v, bh, sk, D, Tl::BN)) != cudaSuccess ||
      (err = tensor_map_f32(&tm_o, o, bh, sq, D, Tl::BM)) != cudaSuccess)
    return err;
  dim3 grid;
  if (!launch_grid((sq + Tl::BM - 1) / Tl::BM, bh, 1, causal,
                   2LL * sk * D * sizeof(float), &grid))
    return cudaErrorInvalidValue;
  kernel<<<grid, Tl::THREADS, Tl::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<float*>(lse), sq, sk, sm_scale,
      causal, threshold, keep_prob, seed);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        void* o, void* lse, int bh, int sq, int sk,
                        int causal, float sm_scale, int use_dropout,
                        uint32_t threshold, float keep_prob, DropKey seed,
                        cudaStream_t stream) {
  return use_dropout
             ? launch_tf32_t<D, true>(q, k, v, o, lse, bh, sq, sk, causal,
                                      sm_scale, threshold, keep_prob, seed,
                                      stream)
             : launch_tf32_t<D, false>(q, k, v, o, lse, bh, sq, sk, causal,
                                       sm_scale, threshold, keep_prob, seed,
                                       stream);
}

// ---------------------------------------------------------------------------
// f32 at d = 192 ... 512: split-precision TF32 wgmma, d streamed in chunks
// ---------------------------------------------------------------------------
// Replaces the TPU kernel _fwd_kernel (flexflow_tpu/kernels/
// flash_attention.py:110) for f32 at head dims 192 ... 512 (the wrapper
// pads 129 ... 511 up to a multiple of 64), where the wide FMA kernel ran
// until this one: the --f32-compute path's attention (NMT's one head of
// 512, any model with heads of 192 ... 512). It computes what that kernel
// computed, to f32 accuracy, on the tensor cores.
//
// Bound at b4 h8 s512 d256: three TF32 passes of 4 * d flops per (query,
// key) pair, 25.8 GFLOP at 495 TFLOP/s (52.06 us), against q, k, v read
// and o written once, 67.1 MB (20.03 us at 3.35 TB/s): operations; at
// d 512 104.1 us; NMT's b64 h1 s128 d512 20.03 us by the bytes.
//
// Design. The d <= 128 kernel above keeps Q's hi and lo parts resident
// and whole K and V tiles beside them: 128 KB of Q alone at d = 256,
// 256 KB (past the 227 KB a CTA may take) at d = 512, and a 64 x D
// accumulator of D / 2 registers a thread. Here:
//   - a CTA owns 64 query rows and ALL D columns of o, so every score is
//     computed once per query block (the FMA kernel computed it D / 64
//     times, once per 64-column chunk of o): its two warpgroups split D,
//     each owning D / 2 columns of o (a D / 4-register accumulator, 128
//     at d = 512) and contracting its half of D for S; the two partial
//     score tiles are summed through shared memory (exchange_store /
//     exchange_add, as the wide bf16 kernel does above d = 320), so both
//     hold the same S and run the same softmax;
//   - nothing is resident: each warpgroup streams its half of D in
//     chunks of 32 columns (one TMA box, one 128-byte swizzle atom wide)
//     through its own ring of three stages on mbarriers, per key tile
//     first Q and K chunk by chunk for S, then V chunk by chunk for P.V,
//     so two copies are in flight behind every chunk's work and shared
//     memory does not grow with D (Q is re-read from L2 once per key
//     tile: 8 x 16.8 MB at b4 h8 s512 d256);
//   - S = Q . K^T takes Q as the register A operand: each thread loads
//     its TF32 A fragments of a Q chunk from shared memory and splits
//     them in registers (tf32_split), so Q is read from shared memory once
//     per chunk, not three times, and never written back; K is split in
//     place into hi with its lo beside it (split_tile_tf32), and S runs
//     three RS passes a_lo . b_hi, a_hi . b_lo, then a_hi . b_hi per chunk
//     (m64n64k8: the whole key tile's width), as the d <= 128 kernel;
//   - O += P . V: P, split into hi and lo A fragments in registers
//     (tf32_a_frags), is the register A operand; each V chunk is
//     transposed into V^T hi and lo (split_transpose_v, keys in the order
//     (0, 2, 4, 6, 1, 3, 5, 7) within each 8-key group) and multiplies
//     into its 32 columns of the accumulator in three m64n32k8 passes;
//     masks and dropout bits are taken at the true key positions;
//   - a CTA is two warpgroups, one CTA an SM (up to 255 registers a
//     thread: 128 accumulator, 32 S and 32 Q fragment registers at d =
//     512 and 64-key tiles; 64 P fragments in P.V's place).
// The mask, the dropout bits (keep_bits) and the base-2 softmax are the
// other kernels' (online_softmax).
template <int D>
struct Tf32WideTiles {
  static constexpr int NWG = 2;                 // warpgroups per CTA
  static constexpr int THREADS = NWG * WG_THREADS;
  static constexpr int BM = WG_ROWS;            // query rows per CTA
  static constexpr int BN = 64;                 // keys per K/V tile
  static constexpr int NB = BN / 8;             // 8-key blocks of a tile
  static constexpr int CW = 32;                 // columns of a chunk
  static constexpr int HALF = D / NWG;          // columns a warpgroup owns
  static constexpr int CHUNKS = HALF / CW;      // its chunks of q, k or v
  static constexpr int ITEMS = 2 * CHUNKS;      // ring items per key tile
  static constexpr int NS = 3;                  // ring stages a warpgroup
  static constexpr int Q_BYTES = BM * CW * 4;   // a Q chunk
  static constexpr int KV_BYTES = BN * CW * 4;  // a K or V chunk, K lo,
                                                // V^T hi or V^T lo
  // a stage: what TMA lands (a Q and a K chunk, or a V chunk in Q's
  // place), then what the warpgroup derives from it (K lo, or V^T hi
  // and lo)
  static constexpr int RAW_BYTES = Q_BYTES + KV_BYTES;
  static constexpr int STAGE_BYTES = RAW_BYTES + 2 * KV_BYTES;
  // the two warpgroups' rings, then the exchange of their partial S
  static constexpr size_t SMEM = SW_ATOM +
                                 (size_t)NWG * NS * STAGE_BYTES +
                                 (size_t)NWG * BM * BN * 4;
  static_assert(D % 64 == 0 && D >= 192 && D <= 512, "d = 192 ... 512");
  static_assert(HALF % CW == 0, "whole chunks");
  static_assert(SMEM <= SMEM_LIMIT, "fits one CTA");
};

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(Tf32WideTiles<D>::THREADS, 1)
    flash_fwd_wgmma_wide_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                                     const __grid_constant__ CUtensorMap tm_k,
                                     const __grid_constant__ CUtensorMap tm_v,
                                     float* __restrict__ o,
                                     float* __restrict__ lse, int sq, int sk,
                                     float sm_scale, int causal,
                                     uint32_t threshold, float keep_prob,
                                     DropKey seed) {
  using Tl = Tf32WideTiles<D>;
  constexpr int BM = Tl::BM, BN = Tl::BN, NB = Tl::NB, CW = Tl::CW;
  constexpr int C = Tl::CHUNKS, NS = Tl::NS;
  extern __shared__ unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t s0 = (base + SW_ATOM - 1) & ~(uint32_t)(SW_ATOM - 1);
  float4* xbuf = reinterpret_cast<float4*>(
      smem + (s0 - base) + Tl::NWG * NS * Tl::STAGE_BYTES);
  // per warpgroup and stage: the stage's copies landed
  __shared__ __align__(8) uint64_t full[Tl::NWG][NS];

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, wtid = tid % WG_THREADS;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const GridCell cell = grid_cell((sq + BM - 1) / BM);
  const int m0 = cell.block * BM;
  const int bh = cell.bh;
  const int row_w = m0 + warp * 16;  // this warp's first row
  const int qpos[2] = {row_w + g, row_w + g + 8};
  const float scale_log2 = sm_scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;
  const int col0 = wg * Tl::HALF;  // this warpgroup's columns
  const uint32_t ring = s0 + wg * NS * Tl::STAGE_BYTES;

  int n_tiles = (sk + BN - 1) / BN;
  if (causal)  // a tile is live iff its first key is visible to the last row
    n_tiles = min(n_tiles, (m0 + BM - 1) / BN + 1);
  const int n_items = n_tiles * Tl::ITEMS;

  auto stage = [&](int i) { return ring + (i % NS) * Tl::STAGE_BYTES; };
  auto bar = [&](int i) { return smem_u32(&full[wg][i % NS]); };
  const CUtensorMap* map_q = &tm_q;
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  // item i of this warpgroup's ring, issued by one of its threads: of key
  // tile i / ITEMS, chunk j < C of Q and of K, or chunk j - C of V
  auto load_item = [&](int i) {
    const int t = i / Tl::ITEMS, j = i % Tl::ITEMS;
    const uint32_t st = stage(i), b = bar(i);
    if (j < C) {
      mbar_expect_tx(b, Tl::RAW_BYTES);
      tma_load_3d(st, map_q, b, col0 + j * CW, m0, bh);
      tma_load_3d(st + Tl::Q_BYTES, map_k, b, col0 + j * CW, t * BN, bh);
    } else {
      mbar_expect_tx(b, Tl::KV_BYTES);
      tma_load_3d(st, map_v, b, col0 + (j - C) * CW, t * BN, bh);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < Tl::NWG; ++w)
#pragma unroll
      for (int st = 0; st < NS; ++st) mbar_init(smem_u32(&full[w][st]), 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (wtid == 0)
    for (int i = 0; i < min(NS - 1, n_items); ++i) load_item(i);

  float acc[Tl::HALF / 8][4];  // this warpgroup's columns of o
#pragma unroll
  for (int dt = 0; dt < Tl::HALF / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_i[2] = {NEG_INF * LOG2E, NEG_INF * LOG2E};  // running max, base 2
  float l_i[2] = {0.f, 0.f};  // this thread's partial row sums

  // Each ring item: wait for its copies, derive its TF32 parts, publish
  // them to the warpgroup's wgmma (the barrier also frees the previous
  // item's stage, which takes the item NS - 1 ahead), run its products.
  int i = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BN;
    // S over this warpgroup's half of D, chunk by chunk
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < C; ++j, ++i) {
      const uint32_t sQ = stage(i), sK = sQ + Tl::Q_BYTES;
      const uint32_t sKlo = sQ + Tl::RAW_BYTES;
      mbar_wait(bar(i), (i / NS) & 1);
      split_tile_tf32<Tl::KV_BYTES, WG_THREADS>(sK, sKlo, wtid);
      uint32_t qh[4][4], ql[4][4];
      q_frags_tf32(sQ, warp, g, tig, qh, ql);
      fence_proxy_async();
      named_barrier(1 + wg, WG_THREADS);
      if (wtid == 0 && i + NS - 1 < n_items) load_item(i + NS - 1);
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const uint32_t kb = pass == 1 ? sKlo : sK;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_kk_tf32(s, pass == 0 ? ql[kk] : qh[kk],
                           desc_sw128(kb + kk * 32, 16), j + pass + kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs_u32(qh);
      fence_regs_u32(ql);
      fence_acc(s);
    }
    // the two partial tiles summed (a + b rounds as b + a, so both
    // warpgroups hold the same S); the second barrier keeps the next
    // tile's stores from overwriting a partial the other still reads
    exchange_store(xbuf, wg, wtid, s);
    __syncthreads();
    exchange_add(xbuf, wg, wtid, s);
    __syncthreads();

    const uint32_t keep =
        DROPOUT ? keep_bits<NB>(n0, qpos, tig, bh, seed, threshold) : 0u;
    const bool edge = n0 + BN > sk || (causal && n0 + BN - 1 > row_w);
    float alpha[2];
    online_softmax<DROPOUT>(s, m_i, l_i, alpha, n0, edge, qpos, tig, sk,
                            causal, scale_log2, keep, inv_keep);
#pragma unroll
    for (int dt = 0; dt < Tl::HALF / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    uint32_t ph[NB][4], pl[NB][4];
    tf32_a_frags(s, ph, pl);

    // O[:, this warpgroup's columns] += P . V, chunk by chunk
#pragma unroll
    for (int j = 0; j < C; ++j, ++i) {
      const uint32_t sV = stage(i);
      const uint32_t vt_hi = sV + Tl::RAW_BYTES, vt_lo = vt_hi + Tl::KV_BYTES;
      mbar_wait(bar(i), (i / NS) & 1);
      split_transpose_v<CW, BN>(sV, vt_hi, vt_lo, wtid);
      fence_proxy_async();
      named_barrier(1 + wg, WG_THREADS);
      if (wtid == 0 && i + NS - 1 < n_items) load_item(i + NS - 1);
      float(&oc)[4][4] = *reinterpret_cast<float(*)[4][4]>(&acc[4 * j][0]);
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const uint32_t vb = pass == 1 ? vt_lo : vt_hi;
#pragma unroll
        for (int kc = 0; kc < NB; ++kc)
          wgmma_rs_kk_tf32(oc, pass == 0 ? pl[kc] : ph[kc],
                           desc_sw128(vb + (kc >> 2) * (CW * SW_ROW) +
                                          (kc & 3) * 32,
                                      16));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(oc);
    }
    fence_regs_u32(ph);
    fence_regs_u32(pl);
  }

  // o = acc / l, each warpgroup's columns straight from its registers
  // (two floats a thread per 8-column block: every 32-byte sector whole)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = (l == 0.f) ? 1.f : l;
    const float inv_l = 1.f / l_safe;
    if (qpos[r] < sq) {
      float* orow = o + ((size_t)bh * sq + qpos[r]) * D + col0 + 2 * tig;
#pragma unroll
      for (int dt = 0; dt < Tl::HALF / 8; ++dt)
        *reinterpret_cast<float2*>(orow + 8 * dt) = make_float2(
            acc[dt][2 * r] * inv_l, acc[dt][2 * r + 1] * inv_l);
      if (wg == 0 && tig == 0)
        lse[(size_t)bh * sq + qpos[r]] = m_i[r] * LN2 + logf(l_safe);
    }
  }
}

template <int D, bool DROPOUT>
cudaError_t launch_tf32_wide_t(const void* q, const void* k, const void* v,
                               void* o, void* lse, int bh, int sq, int sk,
                               int causal, float sm_scale,
                               uint32_t threshold, float keep_prob,
                               DropKey seed, cudaStream_t stream) {
  using Tl = Tf32WideTiles<D>;
  auto kernel = flash_fwd_wgmma_wide_tf32_kernel<D, DROPOUT>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, Tl::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v;
  if ((err = tensor_map_f32(&tm_q, q, bh, sq, D, Tl::BM)) != cudaSuccess ||
      (err = tensor_map_f32(&tm_k, k, bh, sk, D, Tl::BN)) != cudaSuccess ||
      (err = tensor_map_f32(&tm_v, v, bh, sk, D, Tl::BN)) != cudaSuccess)
    return err;
  dim3 grid;
  if (!launch_grid((sq + Tl::BM - 1) / Tl::BM, bh, 1, causal,
                   2LL * sk * D * sizeof(float), &grid))
    return cudaErrorInvalidValue;
  kernel<<<grid, Tl::THREADS, Tl::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<float*>(o), static_cast<float*>(lse), sq,
      sk, sm_scale, causal, threshold, keep_prob, seed);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32_wide(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int sq, int sk,
                             int causal, float sm_scale, int use_dropout,
                             uint32_t threshold, float keep_prob,
                             DropKey seed, cudaStream_t stream) {
  return use_dropout
             ? launch_tf32_wide_t<D, true>(q, k, v, o, lse, bh, sq, sk,
                                           causal, sm_scale, threshold,
                                           keep_prob, seed, stream)
             : launch_tf32_wide_t<D, false>(q, k, v, o, lse, bh, sq, sk,
                                            causal, sm_scale, threshold,
                                            keep_prob, seed, stream);
}

// ---------------------------------------------------------------------------
// head dims above 512, f32 and bf16: the wide FMA kernel
// ---------------------------------------------------------------------------
// The route above d = 512, where no model runs and no wgmma kernel is
// compiled (a route by head dim, not a fallback: below it every d and
// type has its tensor-core kernel). The first wide kernel of the port:
// the wgmma kernels hold a (64, D) f32 accumulator in registers, 128 per
// thread at D = 256, beside S, and a (64 + 2 * 64) x D tile ring. Here a
// CTA owns 64 query rows and one 64-column chunk of o (the grid carries D
// / 64 chunks per row block, adjacent in launch order), so its
// accumulator is the d = 64 kernel's 32 registers. It computes the whole
// score tile S = Q . K^T itself, staging Q and K 64 columns at a time
// (scores_wide), so every chunk's CTA repeats the same scores, softmax and
// lse: D / 64 times the score work of one CTA, for a kernel that is plain
// and right. D enters only as a loop bound and a row stride, so it is a
// runtime argument (any multiple of 64), and the shared memory does not
// grow with D.
// bf16 rows are widened to f32 in shared memory, and p is
// rounded to bf16 before P . V, where the reference casts it. With no
// minimum of CTAs per SM ptxas held it to 128 registers and spilled; one
// CTA per SM as the minimum lets it take ~160 with no spill, and it ran
// faster so (PERF.md sec. 6).
template <typename T>
__global__ void __launch_bounds__(NUM_THREADS, 1)
    flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ lse, int sq, int sk, int D,
                          float sm_scale, int causal, int use_dropout,
                          uint32_t threshold, float keep_prob,
                          DropKey seed) {
  constexpr int LD = TILE + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sA = reinterpret_cast<float*>(smem);  // Q chunk
  float* sB = sA + TILE * LD;                  // K chunk
  float* sV = sB + TILE * LD;                  // V, this CTA's columns
  float* sP = sV + TILE * LD;

  const GridCell cell = grid_cell((sq + TILE - 1) / TILE, D / TILE);
  const int m0 = cell.block * TILE;
  const int bh = cell.bh;
  const int col0 = cell.chunk * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const T* qb = q + (size_t)bh * sq * D;
  const T* kb = k + (size_t)bh * sk * D;
  const T* vb = v + (size_t)bh * sk * D;
  const int qpos[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};

  float acc[N_FRAGS][4];
#pragma unroll
  for (int dt = 0; dt < N_FRAGS; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};

  int n_tiles = (sk + TILE - 1) / TILE;
  if (causal)  // a tile is live iff its first key is visible to the last row
    n_tiles = min(n_tiles, (m0 + TILE - 1) / TILE + 1);

  for (int tn = 0; tn < n_tiles; ++tn) {
    const int n0 = tn * TILE;
    float s[N_FRAGS][4];
    scores_wide(s, sA, sB, qb, m0, sq, kb, n0, sk, D, warp, g, tig);
    load_chunk(sV, vb, D, col0, n0, sk);  // after scores_wide's barriers

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
        s[nt][c] = round_to<T>(pe);  // p cast to v's type
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + rowsum[r];
#pragma unroll
    for (int dt = 0; dt < N_FRAGS; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    __syncthreads();  // the V chunk has landed
    accumulate_pv<TILE>(acc, s, sV, sP, warp, g, tig);
  }

  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = (l == 0.f) ? 1.f : l;
    inv_l[r] = 1.f / l_safe;
    if (cell.chunk == 0 && tig == 0 && qpos[r] < sq)
      lse[(size_t)bh * sq + qpos[r]] = m_i[r] + logf(l_safe);
  }
#pragma unroll
  for (int dt = 0; dt < N_FRAGS; ++dt) {
    acc[dt][0] *= inv_l[0];
    acc[dt][1] *= inv_l[0];
    acc[dt][2] *= inv_l[1];
    acc[dt][3] *= inv_l[1];
  }
  store_chunk(o + (size_t)bh * sq * D, acc, D, col0, m0, sq, warp, g, tig);
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int sq, int sk, int D, int causal,
                        float sm_scale, int use_dropout, uint32_t threshold,
                        float keep_prob, DropKey seed, cudaStream_t stream) {
  const size_t smem = (size_t)4 * TILE * (TILE + 4) * sizeof(float);
  auto kernel = flash_fwd_wide_kernel<T>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if (!launch_grid((sq + TILE - 1) / TILE, bh, D / TILE, causal,
                   2LL * sk * D * sizeof(T), &grid))
    return cudaErrorInvalidValue;
  kernel<<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sq, sk, D, sm_scale, causal, use_dropout, threshold, keep_prob, seed);
  return cudaGetLastError();
}

// Two row blocks per CTA once that still gives two CTAs per SM of an H100
// (132 SMs); the dropout hash leaves no registers for a second block.
constexpr long long TWO_BLOCK_MIN_CTAS = 2 * 132;

}  // namespace

// q: (bh, sq, d), k/v: (bh, sk, d), o: (bh, sq, d), all contiguous in the
// same type (dtype 0 = float32, 1 = bfloat16); lse: (bh, sq) float32.
// d is 64, 128 or any multiple of 64 above 128, or in bf16 also 8, 16, 24
// or 32; bh any count whose grid fits gridDim.x. bf16 at d = 64 and 128
// launches the wgmma kernel, bf16 at d <= 32 the narrow wgmma kernel, bf16
// at d = 192 ... 512 the wide wgmma kernel, f32 at d = 64 and 128 the
// split-precision TF32 wgmma kernel, f32 at d = 192 ... 512 the wide
// split-precision TF32 wgmma kernel, either type above 512 the wide FMA
// kernel. seed_u32, magic, extra, base: the dropout key (DropKey in
// flash_common.cuh). Returns a cudaError_t (0 = launched).
extern "C" int ff_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int bh, int sq, int sk, int head_dim,
                                      int dtype, int causal, float sm_scale,
                                      int use_dropout, unsigned int threshold,
                                      float keep_prob, unsigned int seed_u32,
                                      unsigned int magic, unsigned int extra,
                                      unsigned int base, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || head_dim <= 0)
    return (int)cudaErrorInvalidValue;
  const DropKey seed{seed_u32, magic, extra, base};
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
  // bf16 at d = 8, 16, 24 and 32: the narrow kernel, d unpadded
#define FF_LAUNCH_NARROW(DP)                                               \
  return (int)launch_narrow<DP>(                                           \
      q, k, v, o, lse, bh, sq, sk, head_dim, causal, sm_scale, use_dropout, \
      threshold, keep_prob, seed, st)
  if (dtype == 1 && head_dim % 8 == 0 && head_dim <= 16)
    FF_LAUNCH_NARROW(16);
  if (dtype == 1 && head_dim % 8 == 0 && head_dim <= 32)
    FF_LAUNCH_NARROW(32);
#undef FF_LAUNCH_NARROW
  if (dtype == 0 && head_dim == 64) FF_LAUNCH((launch_tf32<64>));
  if (dtype == 0 && head_dim == 128) FF_LAUNCH((launch_tf32<128>));
  // bf16 at d = 192 ... 512: the wide wgmma kernel, d compiled in
  if (dtype == 1) switch (head_dim) {
      case 192: FF_LAUNCH((launch_wgmma_wide<192>));
      case 256: FF_LAUNCH((launch_wgmma_wide<256>));
      case 320: FF_LAUNCH((launch_wgmma_wide<320>));
      case 384: FF_LAUNCH((launch_wgmma_wide<384>));
      case 448: FF_LAUNCH((launch_wgmma_wide<448>));
      case 512: FF_LAUNCH((launch_wgmma_wide<512>));
      default: break;
    }
  // f32 at d = 192 ... 512: the split-precision TF32 wide kernel, d
  // compiled in
  if (dtype == 0) switch (head_dim) {
      case 192: FF_LAUNCH((launch_tf32_wide<192>));
      case 256: FF_LAUNCH((launch_tf32_wide<256>));
      case 320: FF_LAUNCH((launch_tf32_wide<320>));
      case 384: FF_LAUNCH((launch_tf32_wide<384>));
      case 448: FF_LAUNCH((launch_tf32_wide<448>));
      case 512: FF_LAUNCH((launch_tf32_wide<512>));
      default: break;
    }
#undef FF_LAUNCH
  // above d = 512, f32 and bf16 (no model has it): the wide FMA kernel, d
  // a runtime argument (any multiple of 64)
#define FF_LAUNCH_WIDE(T)                                                  \
  return (int)launch_wide<T>(q, k, v, o, lse, bh, sq, sk, head_dim,       \
                             causal, sm_scale, use_dropout, threshold,     \
                             keep_prob, seed, st)
  if (head_dim > 512 && head_dim % ff_flash::TILE == 0) {
    if (dtype == 0) FF_LAUNCH_WIDE(float);
    if (dtype == 1) FF_LAUNCH_WIDE(__nv_bfloat16);
  }
#undef FF_LAUNCH_WIDE
  return (int)cudaErrorInvalidValue;
}
