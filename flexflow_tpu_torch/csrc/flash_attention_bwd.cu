// Flash-attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel, with a plain C interface.
//
// Replaces the Pallas TPU kernels flexflow_tpu/kernels/flash_attention.py
// ::_bwd_dq_kernel and ::_bwd_dkv_kernel (launched by _flash_bwd_rule).
// Both compute, for every (query row i, key j) the forward saw,
//   s     = (q_i . k_j) * sm_scale in f32, NEG_INF = -1e30 where
//           j >= kv_len or (causal) j > i,
//   p     = exp(s - lse_i),
//   dp    = do_i . v_j, under dropout keep ? dp / (1 - rate) : 0,
//   ds    = p * (dp - delta_i) * sm_scale, delta_i = rowsum(do_i * o_i),
//   p_eff = keep ? p / (1 - rate) : p (p without dropout),
// and accumulate dq_i += ds . k_j (ds cast to k's dtype), dv_j += p_eff .
// do_i (p_eff cast to do's dtype) and dk_j += ds . q_i (ds cast to q's
// dtype) in f32, written once in the input dtype. The keep mask is
// position_hash(seed, global b*h, i, j) >= threshold, the forward's tuple.
//
// Design. On the TPU each kernel's grid runs its reduction axis in order
// on one core and carries the sum in VMEM scratch (dq_sc; dk_sc, dv_sc).
// Here one CTA owns one output tile and loops over the other axis itself:
//   - dq: a CTA owns 64 query rows of one b*h and loops over the K/V
//     tiles (up to the causal diagonal), holding dq in registers;
//   - dk/dv: a CTA owns a block of keys of one b*h and loops over the q
//     tiles (from the causal diagonal on), holding dk and dv in registers.
// No output row is written by two CTAs, so no atomics, no second pass,
// and the same inputs give the same bits on every launch. Ragged sq and
// kv_len edges are masked inside the kernels: tiles hold zero rows past
// the edge, out-of-range (i, j) get p = 0, and their rows are never
// written. Dead causal tiles are skipped by the reference's liveness
// rules. Rows with l == 0 need nothing special: the forward's lse = m then
// gives the same p as the forward's. The type picks the kernel inside the
// C entry; neither is a fallback of the other:
//
//   dq, bf16 (the main path) - flash_bwd_dq_wgmma_kernel, built from
//   hopper_common.cuh with the forward's structure. A CTA is one
//   warpgroup owning 64 query rows (b8 h12 s512: 768 CTAs; s128: 192).
//   Its Q and dO tiles come once by TMA, joining K tile 0's mbarrier
//   phase; K and V tiles of 64 keys stream by TMA through a two-stage
//   ring on separate K and V mbarriers, the next tile's copy issued while
//   this tile's products run. lse and delta are per query row, so each
//   thread holds its two rows' values in registers. All three products
//   are wgmma.mma_async: S = Q.K^T and dP = dO.V^T with both operands in
//   shared memory (K-major) in two commit groups, so the exponentials of
//   S run while dP is on the tensor cores; dQ += dS.K with dS rounded to
//   bf16 in registers as the A operand and K read MN-major from the
//   staged tile through the descriptor's transpose bit (the forward's
//   P.V addressing), so there are no scalar gathers and no transposes.
//   p = 2^(s * sm_scale * log2(e) - lse * log2(e)) is one FFMA and one
//   MUFU ex2; the mask is evaluated only in tiles that cross kv_len or
//   the diagonal (rows past sq arrive as zeros and are never written);
//   dropout is a template parameter, its keep bits hashed into one bit
//   per score (keep_bits, shared with the forward) between the issue of
//   the S/dP products and their wait, and applied as a multiply by
//   1 / (1 - rate). dq is written by direct bf16 pair stores.
//
//   dk/dv, bf16 (the main path) - flash_bwd_dkv_wgmma_kernel, built from
//   hopper_common.cuh. A CTA is one warpgroup owning 64 keys (b8 h12 s512:
//   768 CTAs, two per SM; 128-key CTAs of two warpgroups measured slower),
//   with K and V resident in shared memory. Tiles of 64 queries (32 at
//   d = 128, where dk and dv take 128 registers) of Q and dO, with their
//   lse and delta, stream through a two-stage ring of
//   cp.async copies in the 128-byte-swizzled layout (cp.async rather than
//   TMA because lse and delta rows of sq floats are not 16-byte aligned in
//   general, which a tensor map needs), so the next tile's copy is in
//   flight while this tile's products run. It works in the transposed
//   frame (s^T = K . Q^T, dp^T = V . dO^T), so its P^T and dS^T fragments
//   are directly the A operands of dV += P^T . dO and dK += dS^T . Q,
//   rounded to bf16 exactly where the reference casts p_eff and ds. All
//   four products are wgmma.mma_async: s^T and dp^T with both operands in
//   shared memory (K-major), dV and dK with P^T and dS^T in registers and
//   dO and Q read MN-major from the same staged tiles. The exponential is
//   exp2 with log2(e) folded into sm_scale, the mask is evaluated only in
//   tiles that cross an edge or the diagonal, and dropout is a template
//   parameter (the keep mask hashed once per tile into one bit per
//   score), so the tile without it carries none of its registers.
//
//   dq and dk/dv, bf16 at d = 8, 16, 24 and 32 (the Transformer's heads
//   of d = 8) - flash_bwd_dq_wgmma_narrow_kernel and
//   flash_bwd_dkv_wgmma_narrow_kernel: the structure above on tiles of d
//   rounded up to 16 or 32 columns, nothing padded on the host (the
//   narrow forward's tensor maps and swizzles), one warpgroup per CTA and
//   four CTAs an SM. Their header says why.
//
//   dq and dk/dv, f32 at d = 64 ... 512 (the wrapper pads any d up to 64,
//   and from 129 up to a multiple of 64) - flash_bwd_dq_wgmma_tf32_kernel
//   and flash_bwd_dkv_wgmma_tf32_kernel at d = 64 and 128,
//   flash_bwd_dq_wgmma_wide_tf32_kernel and
//   flash_bwd_dkv_wgmma_wide_tf32_kernel at d = 192 ... 512: every product
//   three TF32 wgmma passes of split operands (f32 accuracy, as the f32
//   forwards), a CTA owning blocks of 64 rows and all D columns of its
//   outputs, every operand streamed in 32-column chunks by TMA; at d <=
//   128 each warpgroup owns 64 rows and all of D, above D is split between
//   two warpgroups. Their header says why.
//
//   dq, bf16 at d = 192 ... 512 (every multiple of 64; the wrapper pads
//   any d from 129 up) - flash_bwd_dq_wgmma_wide_kernel: the wide
//   forward's design, a CTA of two warpgroups owning a block of query
//   rows and all D columns of dq: up to d = 320 128 rows, 64 a
//   warpgroup; above, 64 rows with D split between the warpgroups (the
//   partial S and dP tiles summed through shared memory). Its header says
//   why.
//
//   dk/dv, bf16 at d = 192 ... 512 - flash_bwd_dkv_wgmma_wide_kernel: a
//   CTA of two warpgroups owns a block of keys and all D columns of dk and
//   dv, with K and V resident, and sweeps its query tiles twice (dV, then
//   dK), so each sweep holds one 64 x D accumulator per warpgroup: up to
//   d = 320 128 keys, 64 a warpgroup; above, 64 keys with D split between
//   the warpgroups. s^T is computed in both sweeps (10 * d flops per kept
//   pair for the function's 8 * d). Its header says why. On an NVIDIA
//   H100 80GB HBM3 at 700.00 W, b4 h8 s512: 77.26 / 124.29 / 239.06 us
//   at d = 256 / 320 / 512 (bound 17.37 / 21.71 / 34.74 us), where the
//   FMA kernel took 2,155.06 / 3,236.92 / 7,739.27 us.
//
//   either type above d = 512 (no model has it) - the wide FMA kernels
//   (flash_bwd_dq_wide_kernel, flash_bwd_dkv_wide_kernel): one 64-column
//   chunk of the outputs per CTA (their header says why), d a runtime
//   argument.
//
// Every kernel runs on a 1-D grid (grid_cell in flash_common.cuh), so b*h
// has no 65535 limit. Causal dq whose heads' K/V all fit in L2 takes the
// heaviest (last) query blocks of all heads first; causal dk/dv's
// heaviest key blocks are its first, so it keeps the natural order.
//
// Bound. dq does 6*sq*sk*d flops per head (Q.K^T, dO.V^T, dS.K) and dk/dv
// 8*sq*sk*d (Q.K^T, dO.V^T, P^T.dO, dS^T.Q); each reads q, k, v, do once
// plus the f32 lse and delta, and writes its outputs once. At BERT shapes
// (d = 64, s <= 512) both sit near the H100's bf16 ridge: bytes bound at
// s = 128 (dq 2.38 us, dk/dv 2.85 us at b8 h12 d64), operations at s = 512
// (dq 9.77 us, dk/dv 13.03 us at 989 TFLOP/s). Inside the kernels the
// exponentials (one MUFU ex2 per score, 16 per SM per clock) and the
// products serialize in part, as in the forward.

#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace ff_flash;

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
}

// ---------------------------------------------------------------------------
// f32: the exact FMA path
// ---------------------------------------------------------------------------
// Mask, exponentiate and differentiate one 64x64 tile held in C fragments
// by a warp. "Row" is the fragment row (a query in the dq kernel, a key in
// the dk/dv kernel), "col" the fragment column. On return s holds p_eff
// and dp holds ds. lse_of/delta_of give the query's lse and delta.
template <bool KEY_ROWS, typename LseFn, typename DeltaFn>
__device__ __forceinline__ void tile_grads(
    float (&s)[N_FRAGS][4], float (&dp)[N_FRAGS][4], int row0, int col0,
    int warp, int g, int tig, int bh, int sq, int sk, int causal,
    float sm_scale, int use_dropout, uint32_t threshold, float keep_prob,
    DropKey seed, LseFn lse_of, DeltaFn delta_of) {
#pragma unroll
  for (int nt = 0; nt < N_FRAGS; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = row0 + warp * 16 + g + 8 * (c >> 1);
      const int col = col0 + nt * 8 + tig * 2 + (c & 1);
      const int qpos = KEY_ROWS ? col : row;
      const int kpos = KEY_ROWS ? row : col;
      const int qi = KEY_ROWS ? (nt * 8 + tig * 2 + (c & 1)) : (c >> 1);
      float p = 0.f, pe = 0.f, ds = 0.f;
      if (qpos < sq) {
        const bool ok = kpos < sk && (!causal || kpos <= qpos);
        const float sc = ok ? s[nt][c] * sm_scale : NEG_INF;
        p = expf(sc - lse_of(qi));
        float dpv = dp[nt][c];
        pe = p;
        if (use_dropout) {
          const bool keep =
              position_hash(seed, bh, qpos, kpos) >= threshold;
          dpv = keep ? dpv / keep_prob : 0.f;
          pe = keep ? p / keep_prob : 0.f;
        }
        ds = p * (dpv - delta_of(qi)) * sm_scale;
      }
      s[nt][c] = pe;
      dp[nt][c] = ds;
    }
  }
}

__device__ __forceinline__ void zero_frags(float (&s)[N_FRAGS][4]) {
#pragma unroll
  for (int nt = 0; nt < N_FRAGS; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;
  int bh, sq, sk, causal;
  float sm_scale;
  int use_dropout;
  uint32_t threshold;
  float keep_prob;
  DropKey seed;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// head dims above 512: the wide FMA kernels (f32 and bf16)
// ---------------------------------------------------------------------------
// As the wide forward: a CTA owns one 64-column chunk of its output rows
// (dq; or dk and dv), so its accumulators are the d = 64 kernels'
// registers, and it computes the whole score tiles S and dP itself,
// staging the operands 64 columns at a time (scores_wide); every chunk's
// CTA repeats them. D is a runtime argument, as in the wide forward.
// bf16 rows are widened to f32 in shared memory, and ds
// and p_eff are rounded to bf16 before their products, where the
// reference casts them. The dq kernel keeps ptxas's 168 registers and a
// few spilled bytes: one CTA per SM as the minimum removed the spill but
// ran slower, at two CTAs per SM instead of three (PERF.md sec. 6).
template <typename T>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dq, int sq, int sk, int D,
                             float sm_scale, int causal, int use_dropout,
                             uint32_t threshold, float keep_prob,
                             DropKey seed) {
  constexpr int LD = TILE + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sA = reinterpret_cast<float*>(smem);
  float* sB = sA + TILE * LD;
  float* sK = sB + TILE * LD;  // K, this CTA's columns
  float* sP = sK + TILE * LD;

  const GridCell cell = grid_cell((sq + TILE - 1) / TILE, D / TILE);
  const int m0 = cell.block * TILE;
  const int bh = cell.bh;
  const int col0 = cell.chunk * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const T* qb = q + (size_t)bh * sq * D;
  const T* db = dout + (size_t)bh * sq * D;
  const T* kb = k + (size_t)bh * sk * D;
  const T* vb = v + (size_t)bh * sk * D;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = m0 + warp * 16 + g + 8 * r;
    lse_r[r] = qp < sq ? lse[(size_t)bh * sq + qp] : 0.f;
    delta_r[r] = qp < sq ? delta[(size_t)bh * sq + qp] : 0.f;
  }
  auto lse_of = [&](int r) { return lse_r[r]; };
  auto delta_of = [&](int r) { return delta_r[r]; };

  float acc[N_FRAGS][4];
  zero_frags(acc);
  int n_tiles = (sk + TILE - 1) / TILE;
  if (causal)  // a K tile is live iff its first key is visible to the
               // tile's last query (the reference's rule)
    n_tiles = min(n_tiles, (m0 + TILE - 1) / TILE + 1);

  for (int tn = 0; tn < n_tiles; ++tn) {
    const int n0 = tn * TILE;
    float s[N_FRAGS][4], dp[N_FRAGS][4];
    scores_wide(s, sA, sB, qb, m0, sq, kb, n0, sk, D, warp, g, tig);
    scores_wide(dp, sA, sB, db, m0, sq, vb, n0, sk, D, warp, g, tig);
    load_chunk(sK, kb, D, col0, n0, sk);  // after scores_wide's barriers
    tile_grads<false>(s, dp, m0, n0, warp, g, tig, bh, sq, sk, causal,
                      sm_scale, use_dropout, threshold, keep_prob, seed,
                      lse_of, delta_of);
#pragma unroll
    for (int nt = 0; nt < N_FRAGS; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[nt][c] = round_to<T>(dp[nt][c]);
    __syncthreads();  // the K chunk has landed
    accumulate_pv<TILE>(acc, dp, sK, sP, warp, g, tig);  // dq += ds . k
  }
  store_chunk(dq + (size_t)bh * sq * D, acc, D, col0, m0, sq, warp, g, tig);
}

template <typename T>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dkv_wide_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int sq,
                              int sk, int D, float sm_scale, int causal,
                              int use_dropout, uint32_t threshold,
                              float keep_prob, DropKey seed) {
  constexpr int LD = TILE + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sA = reinterpret_cast<float*>(smem);
  float* sB = sA + TILE * LD;
  float* sQ = sB + TILE * LD;   // Q, this CTA's columns
  float* sDO = sQ + TILE * LD;  // dO, this CTA's columns
  float* sP = sDO + TILE * LD;
  float* sLse = sP + TILE * P_LD;
  float* sDelta = sLse + TILE;

  const GridCell cell = grid_cell((sk + TILE - 1) / TILE, D / TILE);
  const int n0 = cell.block * TILE;
  const int bh = cell.bh;
  const int col0 = cell.chunk * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const T* qb = q + (size_t)bh * sq * D;
  const T* db = dout + (size_t)bh * sq * D;
  const T* kb = k + (size_t)bh * sk * D;
  const T* vb = v + (size_t)bh * sk * D;
  auto lse_of = [&](int c) { return sLse[c]; };
  auto delta_of = [&](int c) { return sDelta[c]; };

  float dk_acc[N_FRAGS][4], dv_acc[N_FRAGS][4];
  zero_frags(dk_acc);
  zero_frags(dv_acc);
  const int n_tiles = (sq + TILE - 1) / TILE;
  // causal: a q tile is live iff its last query can see the first key
  const int first = causal ? n0 / TILE : 0;

  for (int tm = first; tm < n_tiles; ++tm) {
    const int m0 = tm * TILE;
    float s[N_FRAGS][4], dp[N_FRAGS][4];
    scores_wide(s, sA, sB, kb, n0, sk, qb, m0, sq, D, warp, g, tig);
    scores_wide(dp, sA, sB, vb, n0, sk, db, m0, sq, D, warp, g, tig);
    // after scores_wide's barriers: the last tile's readers are done
    load_chunk(sQ, qb, D, col0, m0, sq);
    load_chunk(sDO, db, D, col0, m0, sq);
    for (int i = threadIdx.x; i < TILE; i += NUM_THREADS) {
      const int qp = m0 + i;
      sLse[i] = qp < sq ? lse[(size_t)bh * sq + qp] : 0.f;
      sDelta[i] = qp < sq ? delta[(size_t)bh * sq + qp] : 0.f;
    }
    __syncthreads();
    // s^T = k . q^T and dp^T = v . do^T in the key-row frame
    tile_grads<true>(s, dp, n0, m0, warp, g, tig, bh, sq, sk, causal,
                     sm_scale, use_dropout, threshold, keep_prob, seed,
                     lse_of, delta_of);
#pragma unroll
    for (int nt = 0; nt < N_FRAGS; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[nt][c] = round_to<T>(s[nt][c]);    // p_eff cast to do's type
        dp[nt][c] = round_to<T>(dp[nt][c]);  // ds cast to q's type
      }
    accumulate_pv<TILE>(dv_acc, s, sDO, sP, warp, g, tig);  // dv += p^T.do
    accumulate_pv<TILE>(dk_acc, dp, sQ, sP, warp, g, tig);  // dk += ds^T.q
  }
  store_chunk(dk + (size_t)bh * sk * D, dk_acc, D, col0, n0, sk, warp, g,
              tig);
  store_chunk(dv + (size_t)bh * sk * D, dv_acc, D, col0, n0, sk, warp, g,
              tig);
}

template <typename T>
cudaError_t launch_dq_wide(const Args& a, int D) {
  const size_t smem = (size_t)4 * TILE * (TILE + 4) * sizeof(float);
  auto kernel = flash_bwd_dq_wide_kernel<T>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if (!launch_grid((a.sq + TILE - 1) / TILE, a.bh, D / TILE, a.causal,
                   2LL * a.sk * D * sizeof(T), &grid))
    return cudaErrorInvalidValue;
  kernel<<<grid, NUM_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), a.sq, a.sk, D, a.sm_scale, a.causal,
      a.use_dropout, a.threshold, a.keep_prob, a.seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv_wide(const Args& a, int D) {
  const size_t smem =
      ((size_t)5 * TILE * (TILE + 4) + 2 * TILE) * sizeof(float);
  auto kernel = flash_bwd_dkv_wide_kernel<T>;
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if (!launch_grid((a.sk + TILE - 1) / TILE, a.bh, D / TILE, false, 0,
                   &grid))
    return cudaErrorInvalidValue;
  kernel<<<grid, NUM_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.sq, a.sk,
      D, a.sm_scale, a.causal, a.use_dropout, a.threshold, a.keep_prob, a.seed);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 dk/dv: wgmma with a cp.async tile ring
// ---------------------------------------------------------------------------
using namespace ff_hopper;

template <int D>
struct DkvTiles {
  static constexpr int BN = WG_ROWS;  // keys per CTA (one warpgroup), resident
  // query rows per streamed tile: 32 at d = 128, whose two 64-column
  // accumulators (dk, dv) leave registers for 64 x 32 score tiles only
  static constexpr int BM = D == 64 ? 64 : 32;
  static constexpr int NB = BM / 8;  // 8-column blocks of a score tile
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int T_BYTES = BM * D * 2;  // one Q or dO tile
  // Q, dO, then lse and delta (BM floats each), padded to the swizzle
  // period so the next stage's tiles stay 1024-byte aligned
  static constexpr int STAGE_BYTES = 2 * T_BYTES + SW_ATOM;
  // K, V, then a ring of two stages: the q tile in use, the one in flight
  static constexpr size_t SMEM = SW_ATOM + 2 * KV_BYTES + 2 * STAGE_BYTES;
  static_assert(2 * BM * 4 <= SW_ATOM, "lse and delta overflow the pad");
};

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(WG_THREADS, 2)  // two CTAs per SM
    flash_bwd_dkv_wgmma_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        int sq, int sk, float sm_scale, int causal, uint32_t threshold,
        float keep_prob, DropKey seed) {
  using Tl = DkvTiles<D>;
  constexpr int BM = Tl::BM, BN = Tl::BN, NB = Tl::NB;
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t sK = (raw + SW_ATOM - 1) & ~(uint32_t)(SW_ATOM - 1);
  const uint32_t sV = sK + Tl::KV_BYTES;
  const uint32_t sRing = sV + Tl::KV_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const GridCell cell = grid_cell((sk + BN - 1) / BN);
  const int n0 = cell.block * BN;
  const int bh = cell.bh;
  const __nv_bfloat16* qb = q + (size_t)bh * sq * D;
  const __nv_bfloat16* db = dout + (size_t)bh * sq * D;
  const float* lb = lse + (size_t)bh * sq;
  const float* deb = delta + (size_t)bh * sq;
  const int key_w = n0 + warp * 16;  // this warp's first key
  const int kpos[2] = {key_w + g, key_w + g + 8};
  const float scale_log2 = sm_scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;

  const int n_tiles = (sq + BM - 1) / BM;
  // causal: a q tile is live iff its last query can see the first key
  const int first = causal ? n0 / BM : 0;
  const int count = n_tiles - first;

  auto load_q = [&](int i) {
    const int m0 = (first + i) * BM;
    const uint32_t st = sRing + (i & 1) * Tl::STAGE_BYTES;
    load_tile_sw128<BM, D, WG_THREADS>(st, qb, m0, sq, tid);
    load_tile_sw128<BM, D, WG_THREADS>(st + Tl::T_BYTES, db, m0, sq, tid);
    load_vec_f32(st + 2 * Tl::T_BYTES, lb, m0, sq, BM, tid);
    load_vec_f32(st + 2 * Tl::T_BYTES + BM * 4, deb, m0, sq, BM, tid - BM);
  };
  // the ring: K, V and q tile 0; then, after the barrier that frees its
  // stage, each iteration starts the copy of the next q tile
  load_tile_sw128<BN, D, WG_THREADS>(sK, k + (size_t)bh * sk * D, n0, sk,
                                     tid);
  load_tile_sw128<BN, D, WG_THREADS>(sV, v + (size_t)bh * sk * D, n0, sk,
                                     tid);
  load_q(0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero_acc<D>(dk_acc);
  zero_acc<D>(dv_acc);

  for (int i = 0; i < count; ++i) {
    cp_async_wait<0>();  // K, V and q tile i have landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread, and every warp is done with
                      // the stage the next copy overwrites
    if (i + 1 < count) load_q(i + 1);
    cp_async_commit();
    const int m0 = (first + i) * BM;
    const uint32_t sQ = sRing + (i & 1) * Tl::STAGE_BYTES;
    const uint32_t sDO = sQ + Tl::T_BYTES;
    const float* sLse = reinterpret_cast<const float*>(
        smem + (sQ + 2 * Tl::T_BYTES - raw));
    const float* sDelta = sLse + BM;

    // the dropout keep mask of this thread's fragment (bit 4 * nt + c),
    // hashed before the products so its temporaries and their accumulators
    // are never live together
    const uint32_t keep =
        DROPOUT ? keep_bits_t<NB>(m0, kpos, tig, bh, seed, threshold) : 0u;

    // s^T = K . Q^T and dp^T = V . dO^T for the CTA's 64 keys
    float s[NB][4], dp[NB][4];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t a = sK + (kc >> 2) * (BN * SW_ROW) + (kc & 3) * 32;
      const uint32_t b = sQ + (kc >> 2) * (BM * SW_ROW) + (kc & 3) * 32;
      wgmma_ss_kk<NB>(s, desc_sw128(a, 16), desc_sw128(b, 16), kc > 0);
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t a = sV + (kc >> 2) * (BN * SW_ROW) + (kc & 3) * 32;
      const uint32_t b = sDO + (kc >> 2) * (BM * SW_ROW) + (kc & 3) * 32;
      wgmma_ss_kk<NB>(dp, desc_sw128(a, 16), desc_sw128(b, 16), kc > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    // p = exp(s - lse), p_eff and ds, in the transposed frame: fragment
    // rows are keys, columns queries
    const bool edge = m0 + BM > sq || key_w + 16 > sk ||
                      (causal && key_w + 15 > m0);
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
      const int col = nt * 8 + tig * 2;
      const float2 lse2 = *reinterpret_cast<const float2*>(sLse + col);
      const float2 del2 = *reinterpret_cast<const float2*>(sDelta + col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = c & 1, r = c >> 1;
        const int qpos = m0 + col + j;
        const float lse_c = j ? lse2.y : lse2.x;
        const float delta_c = j ? del2.y : del2.x;
        float p = exp2_approx(s[nt][c] * scale_log2 - lse_c * LOG2E);
        if (edge && !(qpos < sq && kpos[r] < sk &&
                      (!causal || kpos[r] <= qpos)))
          p = 0.f;
        float dpv = dp[nt][c];
        float pe = p;
        if (DROPOUT) {
          const bool kept = (keep >> (4 * nt + c)) & 1u;
          dpv = kept ? dpv * inv_keep : 0.f;
          pe = kept ? p * inv_keep : 0.f;
        }
        s[nt][c] = pe;
        dp[nt][c] = p * (dpv - delta_c) * sm_scale;
      }
    }

    // dV += P_eff^T . dO and dK += dS^T . Q: the fragments rounded to bf16
    // in registers, dO and Q read MN-major from the same staged tiles
    uint32_t pa[NB / 2][4], da[NB / 2][4];
    to_a_frags(s, pa);
    to_a_frags(dp, da);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) {
#pragma unroll
      for (int kc = 0; kc < NB / 2; ++kc) {
        const uint32_t b = sDO + h * (BM * SW_ROW) + kc * 2 * SW_ATOM;
        wgmma_rs_m64n64k16<1>(acc_block(dv_acc, h), pa[kc],
                              desc_sw128(b, BM * SW_ROW), 1);
      }
    }
#pragma unroll
    for (int h = 0; h < D / 64; ++h) {
#pragma unroll
      for (int kc = 0; kc < NB / 2; ++kc) {
        const uint32_t b = sQ + h * (BM * SW_ROW) + kc * 2 * SW_ATOM;
        wgmma_rs_m64n64k16<1>(acc_block(dk_acc, h), da[kc],
                              desc_sw128(b, BM * SW_ROW), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs_u32(pa);
    fence_regs_u32(da);
#pragma unroll
    for (int h = 0; h < D / 64; ++h) {
      fence_regs(acc_block(dv_acc, h));
      fence_regs(acc_block(dk_acc, h));
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= sk) continue;
    const size_t off = ((size_t)bh * sk + kpos[r]) * D + tig * 2;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      store2(dk + off + dt * 8, dk_acc[dt][2 * r], dk_acc[dt][2 * r + 1]);
      store2(dv + off + dt * 8, dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

template <int D, bool DROPOUT>
cudaError_t launch_dkv_wgmma_t(const Args& a) {
  using Tl = DkvTiles<D>;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D, DROPOUT>;
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem(kernel, Tl::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if (!launch_grid((a.sk + Tl::BN - 1) / Tl::BN, a.bh, 1, false, 0, &grid))
    return cudaErrorInvalidValue;
  kernel<<<grid, WG_THREADS, Tl::SMEM, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.out0), static_cast<__nv_bfloat16*>(a.out1),
      a.sq, a.sk, a.sm_scale, a.causal, a.threshold, a.keep_prob, a.seed);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const Args& a) {
  return a.use_dropout ? launch_dkv_wgmma_t<D, true>(a)
                       : launch_dkv_wgmma_t<D, false>(a);
}

// ---------------------------------------------------------------------------
// bf16 dq: wgmma with a TMA tile ring
// ---------------------------------------------------------------------------
template <int D>
struct DqTiles {
  static constexpr int BM = WG_ROWS;  // query rows per CTA (one warpgroup)
  static constexpr int BN = 64;       // keys per K/V tile
  static constexpr int NB = BN / 8;   // 8-column blocks of a score tile
  static constexpr int Q_BYTES = BM * D * 2;  // the Q tile, or the dO tile
  static constexpr int KV_BYTES = BN * D * 2;
  // Q and dO, resident, then rings of two stages (the tile in use, the
  // one in flight) for K and for V
  static constexpr size_t SMEM = SW_ATOM + 2 * Q_BYTES + 4 * KV_BYTES;
  // The CTAs per SM the registers must allow. d = 64: 3 (ptxas also meets
  // 4 without spills, but with dropout that measured no faster at s = 512
  // and slower at s = 128; without dropout it stays under 128 registers
  // either way, and the shared memory holds 4 CTAs). d = 128: 2, as many
  // as its tiles fit in shared memory. One warpgroup per CTA: 128-row CTAs
  // of two warpgroups, which read each K/V tile once for both, measured
  // slower at s = 512.
  static constexpr int MIN_CTAS = D == 64 ? 3 : 2;
};

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(WG_THREADS, DqTiles<D>::MIN_CTAS)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int sq, int sk,
                              float sm_scale, int causal, uint32_t threshold,
                              float keep_prob, DropKey seed) {
  using Tl = DqTiles<D>;
  constexpr int BM = Tl::BM, BN = Tl::BN, NB = Tl::NB;
  extern __shared__ unsigned char smem[];
  const uint32_t sQ = (smem_u32(smem) + SW_ATOM - 1) & ~(uint32_t)(SW_ATOM - 1);
  const uint32_t sDO = sQ + Tl::Q_BYTES;
  const uint32_t sKs = sDO + Tl::Q_BYTES;       // K ring
  const uint32_t sVs = sKs + 2 * Tl::KV_BYTES;  // V ring
  // per stage: the K tile (and, first, Q and dO) landed; the V tile landed
  __shared__ __align__(8) uint64_t k_full[2], v_full[2];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const GridCell cell = grid_cell((sq + BM - 1) / BM);
  const int m0 = cell.block * BM;
  const int bh = cell.bh;
  const int row_w = m0 + warp * 16;  // this warp's first query row
  const int qpos[2] = {row_w + g, row_w + g + 8};
  const float scale_log2 = sm_scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;
  // lse (in base 2) and delta of this thread's two rows, 0 past sq
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = qpos[r] < sq;
    lse2[r] = ok ? lse[(size_t)bh * sq + qpos[r]] * LOG2E : 0.f;
    dlt[r] = ok ? delta[(size_t)bh * sq + qpos[r]] : 0.f;
  }

  int n_tiles = (sk + BN - 1) / BN;
  if (causal)  // a K tile is live iff its first key is visible to the
               // CTA's last query (the reference's rule)
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

  // the ring: Q and dO with K/V tile 0 (their bytes join K tile 0's one
  // arrival: a second arrival on a count-1 barrier would close the phase
  // early); then, after the barrier that frees its stage, each iteration
  // starts the copy of K/V tile t + 1
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
    load_kv(0, 2 * Tl::Q_BYTES);
    tma_load_tile<BM, D>(sQ, &tm_q, k_bar(0), m0, bh);
    tma_load_tile<BM, D>(sDO, &tm_do, k_bar(0), m0, bh);
  }

  float acc[D / 8][4];
  zero_acc<D>(acc);

  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(k_bar(t), (t >> 1) & 1);  // K tile t (and Q, dO) have landed
    __syncthreads();  // every warp is done with the stage the next copy
                      // overwrites
    const int n0 = t * BN;
    const uint32_t sK = k_stage(t), sV = v_stage(t);

    // S = Q . K^T, then, once V lands, dP = dO . V^T: both operands
    // K-major in shared memory, one commit group each
    float s[NB][4], dp[NB][4];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t a = sQ + (kc >> 2) * (BM * SW_ROW) + (kc & 3) * 32;
      const uint32_t b = sK + (kc >> 2) * (BN * SW_ROW) + (kc & 3) * 32;
      wgmma_ss_kk<NB>(s, desc_sw128(a, 16), desc_sw128(b, 16), kc > 0);
    }
    wgmma_commit();
    if (tid == 0 && t + 1 < n_tiles) load_kv(t + 1, 0);  // while S runs
    mbar_wait(v_bar(t), (t >> 1) & 1);  // V tile t has landed
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t a = sDO + (kc >> 2) * (BM * SW_ROW) + (kc & 3) * 32;
      const uint32_t b = sV + (kc >> 2) * (BN * SW_ROW) + (kc & 3) * 32;
      wgmma_ss_kk<NB>(dp, desc_sw128(a, 16), desc_sw128(b, 16), kc > 0);
    }
    wgmma_commit();
    // the dropout mask, hashed while the products run
    const uint32_t keep =
        DROPOUT ? keep_bits(n0, qpos, tig, bh, seed, threshold) : 0u;
    const bool edge = n0 + BN > sk || (causal && n0 + BN - 1 > row_w);

    // p = 2^(s * sm_scale * log2(e) - lse * log2(e)), 0 where masked, while
    // dP is on the tensor cores (groups complete in order)
    wgmma_wait<1>();
    fence_acc(s);
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        float p = exp2_approx(fmaf(s[nt][c], scale_log2, -lse2[r]));
        if (edge) {
          const int kpos = n0 + nt * 8 + tig * 2 + (c & 1);
          if (!(kpos < sk && (!causal || kpos <= qpos[r]))) p = 0.f;
        }
        s[nt][c] = p;
      }
    }
    // ds = p * (dp_eff - delta) * sm_scale
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float dpv = dp[nt][c];
        if (DROPOUT) dpv = (keep >> (4 * nt + c)) & 1u ? dpv * inv_keep : 0.f;
        dp[nt][c] = s[nt][c] * (dpv - dlt[c >> 1]) * sm_scale;
      }
    }

    // dQ += dS . K: dS rounded to bf16 in registers, K read MN-major from
    // the staged tile
    uint32_t da[NB / 2][4];
    to_a_frags(dp, da);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) {
#pragma unroll
      for (int kc = 0; kc < NB / 2; ++kc) {
        const uint32_t b = sK + h * (BN * SW_ROW) + kc * 2 * SW_ATOM;
        wgmma_rs_m64n64k16<1>(acc_block(acc, h), da[kc],
                              desc_sw128(b, BN * SW_ROW), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs_u32(da);
#pragma unroll
    for (int h = 0; h < D / 64; ++h) fence_regs(acc_block(acc, h));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= sq) continue;
    __nv_bfloat16* out = dq + ((size_t)bh * sq + qpos[r]) * D + tig * 2;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(out + dt * 8, acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

template <int D, bool DROPOUT>
cudaError_t launch_dq_wgmma_t(const Args& a) {
  using Tl = DqTiles<D>;
  auto kernel = flash_bwd_dq_wgmma_kernel<D, DROPOUT>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, Tl::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if ((err = tensor_map_bf16(&tm_q, a.q, a.bh, a.sq, D, Tl::BM)) !=
          cudaSuccess ||
      (err = tensor_map_bf16(&tm_do, a.dout, a.bh, a.sq, D, Tl::BM)) !=
          cudaSuccess ||
      (err = tensor_map_bf16(&tm_k, a.k, a.bh, a.sk, D, Tl::BN)) !=
          cudaSuccess ||
      (err = tensor_map_bf16(&tm_v, a.v, a.bh, a.sk, D, Tl::BN)) !=
          cudaSuccess)
    return err;
  dim3 grid;
  if (!launch_grid((a.sq + Tl::BM - 1) / Tl::BM, a.bh, 1, a.causal,
                   2LL * a.sk * D * sizeof(__nv_bfloat16), &grid))
    return cudaErrorInvalidValue;
  kernel<<<grid, WG_THREADS, Tl::SMEM, a.stream>>>(
      tm_q, tm_do, tm_k, tm_v, a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.out0), a.sq, a.sk, a.sm_scale, a.causal,
      a.threshold, a.keep_prob, a.seed);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_wgmma(const Args& a) {
  return a.use_dropout ? launch_dq_wgmma_t<D, true>(a)
                       : launch_dq_wgmma_t<D, false>(a);
}

// ---------------------------------------------------------------------------
// bf16 dq at d = 192 ... 512: wgmma with two warpgroups per CTA
// ---------------------------------------------------------------------------
// Replaces the TPU kernel _bwd_dq_kernel (flexflow_tpu/kernels/
// flash_attention.py:169) at head dims above 128 in bf16. Bound at b4 h8
// s512: 6 * s^2 * d flops per head, 12.9 GFLOP at d = 256 (13.03 us at 989
// TFLOP/s) against 42.2 MB of q, k, v, do, lse, delta and dq (12.6 us at
// 3.35 TB/s); 25.8 GFLOP at d = 512 (26.06 us) against 84.0 MB (25.1 us).
// So the tensor cores set the bound, with the bytes close behind.
//
// Design. The wide forward's (flash_attention_fwd.cu,
// flash_fwd_wgmma_wide_kernel): a CTA of two warpgroups owns a block of
// query rows of one b*h and all D columns of dq, so each score tile is
// computed once, and the block is as tall as the registers allow, since
// every query block reads all of K and V from L2:
//   - d <= 320: 128 rows, each warpgroup owning 64 of them and all D
//     columns (D / 2 accumulator registers a thread). S = Q . K^T and
//     dP = dO . V^T are wgmma with both operands K-major in shared memory
//     in two commit groups (dP issued once V lands), so the exponentials
//     of S run while dP is on the tensor cores, as at d <= 128;
//   - d > 320: the two warpgroups split D over 64 rows (WideSplit). Each
//     contracts its half of D's 16-deep steps of S and dP into partial
//     tiles, the partials are summed through shared memory, and each
//     builds p and dS on the whole tile (the exponentials twice, the
//     products once).
// dS, rounded to bf16 as the reference casts it, is the register A
// operand of dQ[:, own blocks] += dS . K[:, own blocks], K read MN-major
// from the staged tile. Q and dO stay resident; K and V tiles stream by
// TMA through the two-stage mbarrier ring of the d <= 128 kernel. The key
// tile is the widest of 64, 32 and 16 keys whose ring fits beside Q and
// dO (and the exchange buffers) in 227 KB: 64 at d = 192, 32 at 256 and
// 384, 16 at 320, 448 and 512. lse and delta are per query row, two
// registers per thread; the mask and the dropout bits are the d <= 128
// kernel's. One CTA per SM.

// dq's tiles: WideSplit's rows and D split, with Q and dO resident and
// key tiles of the widest of 64, 32 and 16 whose ring fits beside them.
template <int D>
struct DqWideTiles : WideSplit<D> {
  using Sp = WideSplit<D>;
  static constexpr int BN = Sp::smem(2, 64) <= SMEM_LIMIT   ? 64
                            : Sp::smem(2, 32) <= SMEM_LIMIT ? 32
                                                            : 16;
  static constexpr int NB = BN / 8;  // 8-column blocks of a score tile
  static constexpr int Q_BYTES = Sp::BM * D * 2;  // the Q tile, or dO's
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr size_t SMEM = Sp::smem(2, BN);
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(WideSplit<D>::THREADS, 1)
    flash_bwd_dq_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_do,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   __nv_bfloat16* __restrict__ dq, int sq,
                                   int sk, float sm_scale, int causal,
                                   uint32_t threshold, float keep_prob,
                                   DropKey seed) {
  using Tl = DqWideTiles<D>;
  constexpr int BM = Tl::BM, BN = Tl::BN, NB = Tl::NB;
  extern __shared__ unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t sQ = (base + SW_ATOM - 1) & ~(uint32_t)(SW_ATOM - 1);
  const uint32_t sDO = sQ + Tl::Q_BYTES;
  const uint32_t sKs = sDO + Tl::Q_BYTES;       // K ring
  const uint32_t sVs = sKs + 2 * Tl::KV_BYTES;  // V ring
  // the partial S tiles of both warpgroups, then the partial dP tiles
  float4* xs = reinterpret_cast<float4*>(smem + (sVs + 2 * Tl::KV_BYTES -
                                                 base));
  float4* xdp = xs + Tl::NWG * NB * WG_THREADS;
  // per stage: the K tile (and, first, Q and dO) landed; the V tile landed
  __shared__ __align__(8) uint64_t k_full[2], v_full[2];

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, wtid = tid % WG_THREADS;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const GridCell cell = grid_cell((sq + BM - 1) / BM);
  const int m0 = cell.block * BM;
  const int bh = cell.bh;
  const int r0 = Tl::row0(wg);            // this warpgroup's rows
  const int row_w = m0 + r0 + warp * 16;  // this warp's first query row
  const int qpos[2] = {row_w + g, row_w + g + 8};
  const float scale_log2 = sm_scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;
  // this warpgroup's 16-deep steps of S and dP, and its 64-column blocks
  // of dq
  const int kc0 = Tl::kstep0(wg);
  const int b0 = Tl::first_block(wg);
  const int nblk = Tl::blocks(wg);
  // lse (in base 2) and delta of this thread's two rows, 0 past sq
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = qpos[r] < sq;
    lse2[r] = ok ? lse[(size_t)bh * sq + qpos[r]] * LOG2E : 0.f;
    dlt[r] = ok ? delta[(size_t)bh * sq + qpos[r]] : 0.f;
  }

  int n_tiles = (sk + BN - 1) / BN;
  if (causal)  // a K tile is live iff its first key is visible to the
               // CTA's last query (the reference's rule)
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

  // the ring: Q and dO with K/V tile 0 (their bytes join K tile 0's one
  // arrival); then each iteration starts the copy of K/V tile t + 1
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
    load_kv(0, 2 * Tl::Q_BYTES);
    tma_load_tile<BM, D>(sQ, &tm_q, k_bar(0), m0, bh);
    tma_load_tile<BM, D>(sDO, &tm_do, k_bar(0), m0, bh);
  }

  float acc[Tl::MAX_BLOCKS * 8][4];  // this warpgroup's part of dq
#pragma unroll
  for (int dt = 0; dt < Tl::MAX_BLOCKS * 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(k_bar(t), (t >> 1) & 1);  // K tile t (and Q, dO) have landed
    __syncthreads();  // every warp is done with the stage the next copy
                      // overwrites, and with the other warpgroup's partials
    const int n0 = t * BN;
    const uint32_t sK = k_stage(t), sV = v_stage(t);

    // this warpgroup's S, then, once V lands, its dP (partial, over its
    // half of D, when the warpgroups split D)
    float s[NB][4], dp[NB][4];
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
    if (tid == 0 && t + 1 < n_tiles) load_kv(t + 1, 0);  // while S runs
    mbar_wait(v_bar(t), (t >> 1) & 1);  // V tile t has landed
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < Tl::KSTEPS; ++i) {
      const int kc = kc0 + i;
      const uint32_t a = sDO + (kc >> 2) * (BM * SW_ROW) + r0 * SW_ROW +
                         (kc & 3) * 32;
      const uint32_t b = sV + (kc >> 2) * (BN * SW_ROW) + (kc & 3) * 32;
      wgmma_ss_kk<NB>(dp, desc_sw128(a, 16), desc_sw128(b, 16), i > 0);
    }
    wgmma_commit();
    const uint32_t keep =  // the dropout mask, hashed while the products run
        DROPOUT ? keep_bits<NB>(n0, qpos, tig, bh, seed, threshold) : 0u;
    const bool edge = n0 + BN > sk || (causal && n0 + BN - 1 > row_w);
    if (Tl::ROW_SPLIT) {  // S is done once at most dP is in flight
      wgmma_wait<1>();
      fence_acc(s);
    } else {  // S and dP = the sums of the two warpgroups' partials
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      exchange_store(xs, wg, wtid, s);
      exchange_store(xdp, wg, wtid, dp);
      __syncthreads();
      exchange_add(xs, wg, wtid, s);
      exchange_add(xdp, wg, wtid, dp);
    }

    // p = 2^(s * sm_scale * log2(e) - lse * log2(e)), 0 where masked
    // (split rows: while dP is on the tensor cores)
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        float p = exp2_approx(fmaf(s[nt][c], scale_log2, -lse2[r]));
        if (edge) {
          const int kpos = n0 + nt * 8 + tig * 2 + (c & 1);
          if (!(kpos < sk && (!causal || kpos <= qpos[r]))) p = 0.f;
        }
        s[nt][c] = p;
      }
    }
    if (Tl::ROW_SPLIT) {
      wgmma_wait<0>();
      fence_acc(dp);
    }
    // ds = p * (dp_eff - delta) * sm_scale
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float dpv = dp[nt][c];
        if (DROPOUT) dpv = (keep >> (4 * nt + c)) & 1u ? dpv * inv_keep : 0.f;
        dp[nt][c] = s[nt][c] * (dpv - dlt[c >> 1]) * sm_scale;
      }
    }

    // dQ[:, own blocks] += dS . K[:, own blocks]: dS rounded to bf16 in
    // registers, K read MN-major from the staged tile
    uint32_t da[NB / 2][4];
    to_a_frags(dp, da);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < Tl::MAX_BLOCKS; ++h) {
      if (h < nblk) {
#pragma unroll
        for (int kc = 0; kc < NB / 2; ++kc) {
          const uint32_t b = sK + (b0 + h) * (BN * SW_ROW) + kc * 2 * SW_ATOM;
          wgmma_rs_m64n64k16<1>(acc_block(acc, h), da[kc],
                                desc_sw128(b, BN * SW_ROW), 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs_u32(da);
#pragma unroll
    for (int h = 0; h < Tl::MAX_BLOCKS; ++h) fence_regs(acc_block(acc, h));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= sq) continue;
    __nv_bfloat16* out =
        dq + ((size_t)bh * sq + qpos[r]) * D + b0 * 64 + tig * 2;
#pragma unroll
    for (int h = 0; h < Tl::MAX_BLOCKS; ++h) {
      if (h < nblk) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int dt = h * 8 + j;
          store2(out + dt * 8, acc[dt][2 * r], acc[dt][2 * r + 1]);
        }
      }
    }
  }
}

template <int D, bool DROPOUT>
cudaError_t launch_dq_wgmma_wide_t(const Args& a) {
  using Tl = DqWideTiles<D>;
  auto kernel = flash_bwd_dq_wgmma_wide_kernel<D, DROPOUT>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, Tl::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if ((err = tensor_map_bf16(&tm_q, a.q, a.bh, a.sq, D, Tl::BM)) !=
          cudaSuccess ||
      (err = tensor_map_bf16(&tm_do, a.dout, a.bh, a.sq, D, Tl::BM)) !=
          cudaSuccess ||
      (err = tensor_map_bf16(&tm_k, a.k, a.bh, a.sk, D, Tl::BN)) !=
          cudaSuccess ||
      (err = tensor_map_bf16(&tm_v, a.v, a.bh, a.sk, D, Tl::BN)) !=
          cudaSuccess)
    return err;
  dim3 grid;
  if (!launch_grid((a.sq + Tl::BM - 1) / Tl::BM, a.bh, 1, a.causal,
                   2LL * a.sk * D * sizeof(__nv_bfloat16), &grid))
    return cudaErrorInvalidValue;
  kernel<<<grid, WideSplit<D>::THREADS, Tl::SMEM, a.stream>>>(
      tm_q, tm_do, tm_k, tm_v, a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.out0), a.sq, a.sk, a.sm_scale, a.causal,
      a.threshold, a.keep_prob, a.seed);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_wgmma_wide(const Args& a) {
  return a.use_dropout ? launch_dq_wgmma_wide_t<D, true>(a)
                       : launch_dq_wgmma_wide_t<D, false>(a);
}

// ---------------------------------------------------------------------------
// bf16 dk/dv at d = 192 ... 512: wgmma, two warpgroups, two sweeps
// ---------------------------------------------------------------------------
// Replaces the TPU kernel _bwd_dkv_kernel (flexflow_tpu/kernels/
// flash_attention.py:210) at head dims above 128 in bf16. Bound at b4 h8
// s512: 8 * s^2 * d flops per head, 17.2 GFLOP at d = 256 (17.37 us at
// 989 TFLOP/s) against 50.5 MB of q, k, v, do, lse, delta, dk and dv
// (15.1 us at 3.35 TB/s); 34.4 GFLOP at d = 512 (34.74 us) against 101
// MB (30.1 us). The tensor cores set the bound, the bytes close behind.
//
// Design. A CTA of two warpgroups owns a block of keys of one b*h and all
// D columns of dk and dv, with K and V resident in shared memory, so no
// score tile is computed for one column chunk and again for the next.
// Holding both 64 x D f32 accumulators would cost D registers a thread
// per 64 keys, past the 255-register limit with the score tiles beside
// them, so the CTA sweeps its query tiles twice, each sweep with one
// accumulator:
//   - sweep 1: s^T = K . Q^T, p_eff from it and lse, dV += P_eff^T . dO;
//     dv is written at its end;
//   - sweep 2: s^T again and dp^T = V . dO^T, ds = p (dp_eff - delta)
//     sm_scale, dK += dS^T . Q.
// s^T is computed twice, 10 * d flops per kept (query, key) pair for the
// function's 8 * d. Each sweep has the wide dq's geometry (WideSplit): up
// to d = 320, 128 keys, each warpgroup owning 64 keys and all D columns
// (D / 2 accumulator registers); above, 64 keys with D split between the
// warpgroups, their partial s^T (and dp^T) tiles summed through shared
// memory (exchange_store / exchange_add), each owning half of the output
// column blocks. The score products are wgmma with both operands K-major
// in shared memory (the transposed frame, as at d <= 128), so the P^T and
// dS^T fragments, rounded to bf16 where the reference casts p_eff and ds,
// are directly the register A operands of dV += P^T . dO and dK += dS^T .
// Q, dO and Q read MN-major from the staged tile. In sweep 2, s^T and
// dp^T are two commit groups, so where each warpgroup owns its keys p's
// exponentials run while dp^T is on the tensor cores. Q and dO tiles with
// their lse and delta rows stream by cp.async through one two-stage ring
// that runs on from sweep 1 into sweep 2; the query tile is the widest of
// 64, 32 and 16 rows whose ring fits beside K, V (and the exchange
// buffers) in 227 KB: 64 at d = 192, 32 at 256 and 384, 16 at 320, 448
// and 512. The mask is evaluated only in tiles that cross an edge or the
// diagonal, causal blocks skip the query tiles none of their keys can
// see, and the dropout bits are hashed per tile (keep_bits_t) while the
// products run. One CTA per SM. Measured slower on an H100 (PERF.md,
// section 6): Q and dO streamed by TMA; K held in registers as the A
// operand of s^T above d = 320; and, at d <= 256, one sweep holding both
// accumulators with D split over 64 keys (8 * d flops, but half the
// keys per CTA and an exchange per tile), which also spills at d = 192.

// dk/dv's tiles: WideSplit's keys (its rows) and D split, with K and V
// resident, and query tiles of the widest of 64, 32 and 16 rows whose ring
// (Q, dO, and their lse and delta rows) fits beside them.
template <int D>
struct DkvWideTiles {
  using Sp = WideSplit<D>;
  // shared memory at query tiles of bm: WideSplit's, K and V resident,
  // plus two stages of lse and delta (bm floats each)
  static constexpr size_t smem(int bm) {
    return Sp::smem(2, bm) + 2 * 2 * (size_t)bm * 4;
  }
  static constexpr int BN = Sp::BM;  // keys per CTA
  static constexpr int BM = smem(64) <= SMEM_LIMIT   ? 64
                            : smem(32) <= SMEM_LIMIT ? 32
                                                     : 16;
  static constexpr int NB = BM / 8;  // 8-column blocks of a score tile
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int T_BYTES = BM * D * 2;  // one Q or dO tile
  static constexpr int STAGE_BYTES = 2 * T_BYTES;
  // the partial s^T tiles of both warpgroups, then the partial dp^T tiles
  static constexpr int X_BYTES =
      Sp::ROW_SPLIT ? 0 : 2 * Sp::NWG * NB * WG_THREADS * 16;
  static constexpr size_t SMEM = smem(BM);
  static_assert(SW_ATOM + 2 * KV_BYTES + 2 * STAGE_BYTES + X_BYTES +
                        4 * BM * 4 ==
                    SMEM,
                "layout");
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(WideSplit<D>::THREADS, 1)
    flash_bwd_dkv_wgmma_wide_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        int sq, int sk, float sm_scale, int causal, uint32_t threshold,
        float keep_prob, DropKey seed) {
  using Tl = DkvWideTiles<D>;
  using Sp = typename Tl::Sp;
  constexpr int BM = Tl::BM, BN = Tl::BN, NB = Tl::NB;
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t sK = (raw + SW_ATOM - 1) & ~(uint32_t)(SW_ATOM - 1);
  const uint32_t sV = sK + Tl::KV_BYTES;
  const uint32_t sRing = sV + Tl::KV_BYTES;
  float4* xs = reinterpret_cast<float4*>(smem + (sRing + 2 * Tl::STAGE_BYTES -
                                                 raw));
  float4* xdp = xs + Sp::NWG * NB * WG_THREADS;
  // per stage: lse, then delta, of its BM queries
  const uint32_t sVec = sRing + 2 * Tl::STAGE_BYTES + Tl::X_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, wtid = tid % WG_THREADS;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const GridCell cell = grid_cell((sk + BN - 1) / BN);
  const int n0 = cell.block * BN;
  const int bh = cell.bh;
  const int r0 = Sp::row0(wg);            // this warpgroup's keys
  const int key_w = n0 + r0 + warp * 16;  // this warp's first key
  const int kpos[2] = {key_w + g, key_w + g + 8};
  const float scale_log2 = sm_scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;
  // this warpgroup's 16-deep steps of s^T and dp^T, and its 64-column
  // blocks of dk and dv
  const int kc0 = Sp::kstep0(wg);
  const int b0 = Sp::first_block(wg);
  const int nblk = Sp::blocks(wg);
  const __nv_bfloat16* qb = q + (size_t)bh * sq * D;
  const __nv_bfloat16* db = dout + (size_t)bh * sq * D;
  const float* lb = lse + (size_t)bh * sq;
  const float* deb = delta + (size_t)bh * sq;

  const int n_tiles = (sq + BM - 1) / BM;
  // causal: a q tile is live iff its last query can see the first key
  const int first = causal ? n0 / BM : 0;
  const int count = max(n_tiles - first, 0);

  // the ring's iteration it is q tile it % count of sweep it / count
  auto load_q = [&](int it) {
    const int m0 = (first + (it < count ? it : it - count)) * BM;
    const uint32_t st = sRing + (it & 1) * Tl::STAGE_BYTES;
    const uint32_t vec = sVec + (it & 1) * 2 * BM * 4;
    load_tile_sw128<BM, D, Sp::THREADS>(st, qb, m0, sq, tid);
    load_tile_sw128<BM, D, Sp::THREADS>(st + Tl::T_BYTES, db, m0, sq, tid);
    load_vec_f32(vec, lb, m0, sq, BM, tid);
    load_vec_f32(vec + BM * 4, deb, m0, sq, BM, tid - BM);
  };
  // K, V and q tile 0; then, after the barrier that frees its stage, each
  // iteration starts the copy of the next q tile
  load_tile_sw128<BN, D, Sp::THREADS>(sK, k + (size_t)bh * sk * D, n0, sk,
                                      tid);
  load_tile_sw128<BN, D, Sp::THREADS>(sV, v + (size_t)bh * sk * D, n0, sk,
                                      tid);
  if (count > 0) load_q(0);
  cp_async_commit();

  float acc[Sp::MAX_BLOCKS * 8][4];  // this warpgroup's part of dv, then dk
#pragma unroll
  for (int sweep = 0; sweep < 2; ++sweep) {  // 0: dv, 1: dk
#pragma unroll
    for (int dt = 0; dt < Sp::MAX_BLOCKS * 8; ++dt)
      acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

    for (int t = 0; t < count; ++t) {
      const int it = sweep * count + t;
      cp_async_wait<0>();  // q tile it (and, first, K and V) have landed
      fence_proxy_async();
      __syncthreads();  // ... for every thread, and every warp is done with
                        // the stage the next copy overwrites and with the
                        // other warpgroup's partials
      if (it + 1 < 2 * count) load_q(it + 1);
      cp_async_commit();
      const int m0 = (first + t) * BM;
      const uint32_t sQ = sRing + (it & 1) * Tl::STAGE_BYTES;
      const uint32_t sDO = sQ + Tl::T_BYTES;
      const float* sLse = reinterpret_cast<const float*>(
          smem + (sVec + (it & 1) * 2 * BM * 4 - raw));
      const float* sDelta = sLse + BM;

      // s^T = K . Q^T, and in sweep 2 dp^T = V . dO^T, for this
      // warpgroup's keys (partial, over its half of D, when the
      // warpgroups split D): both operands K-major in shared memory
      float s[NB][4], dp[NB][4];
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < Sp::KSTEPS; ++i) {
        const int kc = kc0 + i;
        const uint32_t a = sK + (kc >> 2) * (BN * SW_ROW) + r0 * SW_ROW +
                           (kc & 3) * 32;
        const uint32_t b = sQ + (kc >> 2) * (BM * SW_ROW) + (kc & 3) * 32;
        wgmma_ss_kk<NB>(s, desc_sw128(a, 16), desc_sw128(b, 16), i > 0);
      }
      wgmma_commit();
      if (sweep == 1) {
#pragma unroll
        for (int i = 0; i < Sp::KSTEPS; ++i) {
          const int kc = kc0 + i;
          const uint32_t a = sV + (kc >> 2) * (BN * SW_ROW) + r0 * SW_ROW +
                             (kc & 3) * 32;
          const uint32_t b = sDO + (kc >> 2) * (BM * SW_ROW) + (kc & 3) * 32;
          wgmma_ss_kk<NB>(dp, desc_sw128(a, 16), desc_sw128(b, 16), i > 0);
        }
        wgmma_commit();
      }
      const uint32_t keep =  // the dropout mask, hashed while they run
          DROPOUT ? keep_bits_t<NB>(m0, kpos, tig, bh, seed, threshold) : 0u;
      const bool edge = m0 + BM > sq || key_w + 16 > sk ||
                        (causal && key_w + 15 > m0);
      if (Sp::ROW_SPLIT) {  // s^T is done once at most dp^T is in flight
        if (sweep == 1)
          wgmma_wait<1>();
        else
          wgmma_wait<0>();
        fence_acc(s);
      } else {  // the sums of the two warpgroups' partials
        wgmma_wait<0>();
        fence_acc(s);
        exchange_store(xs, wg, wtid, s);
        if (sweep == 1) {
          fence_acc(dp);
          exchange_store(xdp, wg, wtid, dp);
        }
        __syncthreads();
        exchange_add(xs, wg, wtid, s);
        if (sweep == 1) exchange_add(xdp, wg, wtid, dp);
      }

      // p = 2^(s * sm_scale * log2(e) - lse * log2(e)), 0 where masked, in
      // the transposed frame (fragment rows keys, columns queries); sweep 1
      // keeps p_eff, sweep 2 p
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        const int col = nt * 8 + tig * 2;
        const float2 lse2 = *reinterpret_cast<const float2*>(sLse + col);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = c & 1, r = c >> 1;
          const int qpos = m0 + col + j;
          float p = exp2_approx(
              fmaf(s[nt][c], scale_log2, -(j ? lse2.y : lse2.x) * LOG2E));
          if (edge && !(qpos < sq && kpos[r] < sk &&
                        (!causal || kpos[r] <= qpos)))
            p = 0.f;
          if (DROPOUT && sweep == 0)
            p = (keep >> (4 * nt + c)) & 1u ? p * inv_keep : 0.f;
          s[nt][c] = p;
        }
      }
      if (sweep == 1) {
        if (Sp::ROW_SPLIT) {
          wgmma_wait<0>();
          fence_acc(dp);
        }
        // ds = p * (dp_eff - delta) * sm_scale
#pragma unroll
        for (int nt = 0; nt < NB; ++nt) {
          const float2 del2 =
              *reinterpret_cast<const float2*>(sDelta + nt * 8 + tig * 2);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float dpv = dp[nt][c];
            if (DROPOUT)
              dpv = (keep >> (4 * nt + c)) & 1u ? dpv * inv_keep : 0.f;
            dp[nt][c] =
                s[nt][c] * (dpv - ((c & 1) ? del2.y : del2.x)) * sm_scale;
          }
        }
      }

      // dV[:, own blocks] += P_eff^T . dO[:, own blocks] (sweep 1) or
      // dK[:, own blocks] += dS^T . Q[:, own blocks] (sweep 2): the
      // fragments rounded to bf16 in registers, dO or Q read MN-major
      // from the staged tile
      uint32_t fa[NB / 2][4];
      to_a_frags(sweep == 0 ? s : dp, fa);
      const uint32_t sB = sweep == 0 ? sDO : sQ;
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < Sp::MAX_BLOCKS; ++h) {
        if (h < nblk) {
#pragma unroll
          for (int kc = 0; kc < NB / 2; ++kc) {
            const uint32_t b = sB + (b0 + h) * (BM * SW_ROW) + kc * 2 * SW_ATOM;
            wgmma_rs_m64n64k16<1>(acc_block(acc, h), fa[kc],
                                  desc_sw128(b, BM * SW_ROW), 1);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs_u32(fa);
#pragma unroll
      for (int h = 0; h < Sp::MAX_BLOCKS; ++h) fence_regs(acc_block(acc, h));
    }

    // this sweep's output: this thread's two keys, its warpgroup's blocks
    __nv_bfloat16* out = sweep == 0 ? dv : dk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kpos[r] >= sk) continue;
      __nv_bfloat16* row =
          out + ((size_t)bh * sk + kpos[r]) * D + b0 * 64 + tig * 2;
#pragma unroll
      for (int h = 0; h < Sp::MAX_BLOCKS; ++h) {
        if (h < nblk) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int dt = h * 8 + j;
            store2(row + dt * 8, acc[dt][2 * r], acc[dt][2 * r + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA (count = 0: K and V)
}

template <int D, bool DROPOUT>
cudaError_t launch_dkv_wgmma_wide_t(const Args& a) {
  using Tl = DkvWideTiles<D>;
  auto kernel = flash_bwd_dkv_wgmma_wide_kernel<D, DROPOUT>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, Tl::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid;  // causal dk/dv's heaviest key blocks are its first
  if (!launch_grid((a.sk + Tl::BN - 1) / Tl::BN, a.bh, 1, false, 0, &grid))
    return cudaErrorInvalidValue;
  kernel<<<grid, WideSplit<D>::THREADS, Tl::SMEM, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.out0), static_cast<__nv_bfloat16*>(a.out1),
      a.sq, a.sk, a.sm_scale, a.causal, a.threshold, a.keep_prob, a.seed);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma_wide(const Args& a) {
  return a.use_dropout ? launch_dkv_wgmma_wide_t<D, true>(a)
                       : launch_dkv_wgmma_wide_t<D, false>(a);
}

// ---------------------------------------------------------------------------
// f32 dq and dk/dv: split-precision TF32 wgmma (d = 64 ... 512)
// ---------------------------------------------------------------------------
// Replace the TPU kernels _bwd_dq_kernel and _bwd_dkv_kernel (flexflow_tpu/
// kernels/flash_attention.py:169, :210) for f32 at head dims 64 ... 512
// (the wrapper pads any f32 d up to 64, or from 129 up to a multiple of
// 64): the --f32-compute path's backward (BERT's, GPT-2's and LLaMA's
// heads of 64 and 128; NMT's one head of 512), where exact FMA kernels
// ran before these. They compute what those kernels computed, to f32
// accuracy, on the tensor cores.
//
// Bound: three TF32 passes of 6 * d (dq) or 8 * d (dk/dv) flops per kept
// (query, key) pair at 495 TFLOP/s. b1 h8 s512 causal (the search's
// calibration shape, 1,050,624 kept pairs): 2.45 / 3.26 us at d 64, 4.89
// / 6.52 us at d 128; BERT-base under --f32-compute, b8 h12 s512 d64:
// 58.57 / 78.09 us, where its bytes take 18.9 / 22.7 us at 3.35 TB/s.
// b4 h8 s512 d256: 78.09 / 104.12 us (its bytes 25.1 / 30.1 us); at d 512
// 156.18 / 208.24 us; NMT's b64 h1 s128 d512 25.06 / 30.07 us by the
// bytes. Operations everywhere else.
//
// Design. Every product is three TF32 wgmma passes of split operands
// (a_lo . b_hi, a_hi . b_lo, then a_hi . b_hi), f32 accumulators, nothing
// rounded between products but by the split. The tensor cores round each
// step of an accumulation chain toward zero, so no chain runs longer
// than one 32-column chunk (12 steps) or one tile's gradient product (3 *
// BN / 8): their results are summed in f32, rounding to nearest, the
// score partials in shared memory (partial_add), the gradients in
// registers. With chains over all of d and all tiles, the gradients came
// out 1.0-1.5e-5 of the largest low at d 256-512 (BWD_TOL is 1e-5).
//   - A CTA owns blocks of 64 rows (dq: queries; dk/dv: keys) and all D
//     columns of its outputs, so each score is computed once per row
//     block. How its warpgroups share them is Tf32BwdTiles's choice: at
//     d 192 ... 512 two warpgroups split D over one 64-row block (a D /
//     4-register accumulator each) and sum their partial score tiles
//     through shared memory (exchange_store / exchange_add) so both hold
//     the same tile; at d 64 and 128 each warpgroup owns 64 rows and all
//     of D (a D / 2-register accumulator), nothing is exchanged, and the
//     two warpgroups of a CTA share the streamed chunks.
//   - Nothing is resident: the owned rows and the streamed tiles (64 rows:
//     keys in dq, queries in dk/dv) come in 32-column chunks (one TMA box,
//     one 128-byte swizzle atom wide) through rings of three stages on
//     mbarriers, two copies in flight behind every chunk's work.
//   - The score products (dq: S = Q . K^T, dP = dO . V^T; dk/dv, in the
//     transposed frame: s^T = K . Q^T, dp^T = V . dO^T) take the owned
//     rows' chunk as register A fragments split in registers
//     (q_frags_tf32) and the streamed chunk split in place into hi with
//     its lo beside it (split_tile_tf32).
//   - The gradient products contract over the streamed rows (dq: dQ +=
//     dS . K; dk/dv: dV += P_eff^T . dO, dK += dS^T . Q), which TF32
//     wgmma, K-major only, cannot read from the chunk as it lands: the
//     chunk is streamed once more per tile and transposed into hi and lo
//     (split_transpose_v, rows in the order (0, 2, 4, 6, 1, 3, 5, 7)
//     within each 8-row group), so the score accumulator becomes the A
//     fragments in place (tf32_a_frags). The second copy costs L2 traffic,
//     not shared memory, where no room is left for the whole tile's
//     transposes (128 KB at d 512).
//   - dk/dv sweeps its query tiles twice, dV then dK, where both
//     accumulators would not fit (D / 2 registers each at d 512): s^T is
//     then computed in both, 10 * d flops per kept pair for the function's
//     8 * d. Where they fit (d 64), one sweep computes s^T once.
//   - Above d = 320 p waits in shared memory while dP runs, so the D /
//     4-register accumulator, dP's partial and the fragments fit 255
//     registers.
//   - The score items' chunk loops stay rolled (only the first chunk's
//     store depends on the chunk), the gradient items' unrolled (each
//     indexes its 32 accumulator columns): fully unrolled, dk/dv's code
//     (17,384 SASS instructions at d 512, with the 32-row tiles of an
//     earlier design) outran the instruction cache, and every phase of
//     its dK sweep ran at about half speed.
//   - lse and delta: per query row, two registers a thread in dq; in dk/dv
//     per column of the transposed frame, so each tile's rows come by
//     cp.async into shared memory (not 16-byte aligned in general, which
//     TMA needs).
// The mask, the liveness of causal tiles, the dropout bits (keep_bits,
// keep_bits_t) and the base-2 exponential are the bf16 kernels'. No
// atomics: a CTA owns its output rows.

// How a CTA's two warpgroups share its rows and the D columns of its
// outputs, and the shared memory that takes:
//   - d 192 ... 512 (SPLIT_D): one block of 64 rows, each warpgroup owning
//     D / 2 output columns and contracting its half of D for the score
//     tiles; each streams its half through its own ring;
//   - d 64 and 128: each warpgroup owns its own 64 rows and all D columns;
//     one ring, each stage holding both warpgroups' chunks of their owned
//     rows and one streamed chunk, which both split (and the first
//     transposes) once for both. dk/dv sweeps once where both accumulators
//     fit (ONE_SWEEP, d 64), else twice, dV then dK.
// See PERF.md sec. 6 for the designs measured.
template <int D>
struct Tf32BwdTiles {
  static constexpr int DIM = D;
  static constexpr bool SPLIT_D = D > 128;
  static constexpr int NWG = 2;  // warpgroups per CTA
  static constexpr int THREADS = NWG * WG_THREADS;
  // rows a CTA owns (queries; keys)
  static constexpr int BM = SPLIT_D ? WG_ROWS : NWG * WG_ROWS;
  // rows of a streamed tile (keys in dq, queries in dk/dv): 64 at every
  // d, so the score products are m64n64 (32-row tiles above d = 320, whose
  // score products were m64n32, measured slower: PERF.md sec. 6)
  static constexpr int BN = 64;
  static constexpr int NB = BN / 8;             // 8-row blocks of a tile
  static constexpr int CW = 32;                 // columns of a chunk
  static constexpr int HALF = SPLIT_D ? D / 2 : D;  // columns a warpgroup owns
  static constexpr int CHUNKS = HALF / CW;      // its chunks of a tensor
  static constexpr int NS = 3;                  // stages of a ring
  static constexpr int RINGS = SPLIT_D ? NWG : 1;
  static constexpr int A_SLOTS = SPLIT_D ? 1 : NWG;  // owned chunks a stage
  static constexpr int A_BYTES = WG_ROWS * CW * 4;  // a warpgroup's chunk
  static constexpr int B_BYTES = BN * CW * 4;   // a chunk of a streamed tile
  static constexpr int B_OFF = A_SLOTS * A_BYTES;
  // a stage: the owned rows' chunks, the streamed chunk, then what is
  // derived from the latter: its lo beside it, or its transposed lo there
  // and its transposed hi in the owned rows' slots (a gradient item loads
  // no owned rows)
  static constexpr int STAGE_BYTES = B_OFF + 2 * B_BYTES;
  // each warpgroup's partial (SPLIT_D: summed with the other's) score tile
  static constexpr int X_TILE = NWG * WG_ROWS * BN * 4;
  // above d = 320 p waits in shared memory (each thread's own slots) while
  // dP runs: the D / 4-register accumulator leaves no room to hold it
  // beside dP's product (dq at d 448 and 512 spilled)
  static constexpr bool P_STASH = D > 320;
  static constexpr int P_BYTES = P_STASH ? X_TILE : 0;
  // with D split, consecutive score sums alternate between two buffers
  // where they fit, so a sum needs one CTA barrier, not two (score_sum)
  static constexpr int X_BUFS = SPLIT_D && !P_STASH ? 2 : 1;
  static constexpr int X_BYTES = X_BUFS * X_TILE;
  // dk/dv: lse and delta of the query tile in use and of the next one
  static constexpr int VEC_BYTES = 2 * 2 * BN * 4;
  static constexpr size_t SMEM = SW_ATOM + (size_t)RINGS * NS * STAGE_BYTES +
                                 X_BYTES + P_BYTES + VEC_BYTES;
  // dk/dv computes dV and dK in one sweep (both accumulators held)
  static constexpr bool ONE_SWEEP = D <= 64;
  static_assert(D % 64 == 0 && D >= 64 && D <= 512, "d = 64 ... 512");
  static_assert(HALF % CW == 0, "whole chunks");
  static_assert(B_OFF >= B_BYTES, "the transposed hi fits the owned slots");
  static_assert(SMEM <= SMEM_LIMIT, "fits the SM");
  __device__ static int row0(int wg) { return SPLIT_D ? 0 : wg * WG_ROWS; }
  __device__ static int col0(int wg) { return SPLIT_D ? wg * HALF : 0; }
  __device__ static int ring(int wg) { return SPLIT_D ? wg : 0; }
  // the thread that issues a ring's copies
  __device__ static bool issuer(int wg, int wtid) {
    return wtid == 0 && (SPLIT_D || wg == 0);
  }
  // the threads of a ring wait for each other: its warpgroup, or the CTA
  __device__ static void sync(int wg) {
    named_barrier(1 + ring(wg), SPLIT_D ? WG_THREADS : THREADS);
  }
};

// This thread's own slots of buf, as exchange_store wrote them.
template <int NB>
__device__ __forceinline__ void exchange_load(const float4* buf, int wg,
                                              int wtid, float (&s)[NB][4]) {
#pragma unroll
  for (int nt = 0; nt < NB; ++nt) {
    const float4 o = buf[(wg * NB + nt) * WG_THREADS + wtid];
    s[nt][0] = o.x;
    s[nt][1] = o.y;
    s[nt][2] = o.z;
    s[nt][3] = o.w;
  }
}

// Add one chunk's partial score tile t into this thread's own slots of
// buf in f32, rounding to nearest (the first chunk stores it), so the
// tensor cores' chain, which rounds toward zero at each step, ends with
// the chunk (12 steps; see the header).
template <int NB>
__device__ __forceinline__ void partial_add(float4* buf, int wg, int wtid,
                                            const float (&t)[NB][4],
                                            bool first) {
#pragma unroll
  for (int nt = 0; nt < NB; ++nt) {
    float4* slot = buf + (wg * NB + nt) * WG_THREADS + wtid;
    float4 o = make_float4(t[nt][0], t[nt][1], t[nt][2], t[nt][3]);
    if (!first) {
      const float4 x = *slot;
      o = make_float4(x.x + o.x, x.y + o.y, x.z + o.z, x.w + o.w);
    }
    *slot = o;
  }
}

// The exchange buffer of the n-th score sum of a CTA (Tl::X_BUFS).
template <typename Tl>
__device__ __forceinline__ float4* score_buf(float4* xbuf, int n) {
  return xbuf + (Tl::X_BUFS == 2 ? n & 1 : 0) * (Tl::X_TILE / 16);
}

// The score tile into s from this thread's slots of buf: with D split,
// this warpgroup's sum of its chunks' partials plus the other's (a + b
// rounds as b + a, so both hold the same tile). With one buffer, a second
// barrier keeps the next sum's partials from overwriting a sum the other
// warpgroup still reads; with two, the next sum's barrier, which neither
// warpgroup passes before both have read this one, guards the sum after
// it. Without the split, this warpgroup's own sum, which no other thread
// touches.
template <typename Tl, int NB>
__device__ __forceinline__ void score_sum(const float4* buf, int wg,
                                          int wtid, float (&s)[NB][4]) {
  if constexpr (Tl::SPLIT_D) __syncthreads();
  exchange_load(buf, wg, wtid, s);
  if constexpr (Tl::SPLIT_D) {
    exchange_add(buf, wg, wtid, s);
    if constexpr (Tl::X_BUFS == 1) __syncthreads();
  }
}

// One ring item of a score product over a 32-column chunk: wait for the
// owned rows' chunks and the streamed chunk (at B_OFF); split the
// streamed chunk in place into hi with its lo beside it (the ring's
// threads together) and this warpgroup's owned chunk into register
// fragments; publish them to the ring's wgmma (the barrier also frees the
// previous item's stage, which `next` refills); the chunk's A . B^T in
// three RS passes, the two small ones first, added into this thread's
// slots of part (partial_add; the first chunk stores).
template <typename Tl, typename Next>
__device__ __forceinline__ void tf32_score_item(
    float4* part, uint32_t st, uint32_t bar, uint32_t parity, bool first,
    int wg, int wtid, int warp, int g, int tig, Next&& next) {
  const uint32_t sA = st + (Tl::SPLIT_D ? 0 : wg * Tl::A_BYTES);
  const uint32_t sB = st + Tl::B_OFF, sBlo = sB + Tl::B_BYTES;
  mbar_wait(bar, parity);
  if constexpr (Tl::SPLIT_D)
    split_tile_tf32<Tl::B_BYTES, WG_THREADS>(sB, sBlo, wtid);
  else
    split_tile_tf32<Tl::B_BYTES, Tl::THREADS>(sB, sBlo,
                                              wg * WG_THREADS + wtid);
  uint32_t ah[4][4], al[4][4];
  q_frags_tf32(sA, warp, g, tig, ah, al);
  fence_proxy_async();
  Tl::sync(wg);
  next();
  float t[Tl::NB][4];
  wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t kb = pass == 1 ? sBlo : sB;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_kk_tf32(t, pass == 0 ? al[kk] : ah[kk],
                       desc_sw128(kb + kk * 32, 16), pass + kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs_u32(ah);
  fence_regs_u32(al);
  fence_acc(t);
  partial_add(part, wg, wtid, t, first);
}

// One ring item of a gradient product over a 32-column chunk: wait for
// the streamed chunk (at B_OFF), transpose it into hi (at the stage's
// start, the owned rows' slots, which this item does not load) and lo
// (after the chunk; split_transpose_v: rows the chunk's 32 columns, the
// streamed rows contiguous in the fragments' order; with D split each
// warpgroup its own, else the first warpgroup for the ring), publish,
// refill the freed stage; oc (this warpgroup's 64 x 32 block of the
// output) += F . chunk, three RS passes into a fresh accumulator added to
// oc in f32 (the tensor cores' chain kept to one tile, as partial_add
// keeps the scores'), F the hi / lo fragments (fh, fl) of a 64 x BN
// score-shaped tile (dS, P_eff^T or dS^T).
template <typename Tl, typename Next>
__device__ __forceinline__ void tf32_grad_item(
    float (&oc)[4][4], const uint32_t (&fh)[Tl::NB][4],
    const uint32_t (&fl)[Tl::NB][4], uint32_t st, uint32_t bar,
    uint32_t parity, int wg, int wtid, Next&& next) {
  constexpr int CW = Tl::CW;
  const uint32_t sB = st + Tl::B_OFF;
  const uint32_t t_hi = st, t_lo = sB + Tl::B_BYTES;
  mbar_wait(bar, parity);
  if (Tl::SPLIT_D || wg == 0)
    split_transpose_v<CW, Tl::BN>(sB, t_hi, t_lo, wtid);
  fence_proxy_async();
  Tl::sync(wg);
  next();
  float t[4][4];
  wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t tb = pass == 1 ? t_lo : t_hi;
#pragma unroll
    for (int kc = 0; kc < Tl::NB; ++kc)
      wgmma_rs_kk_tf32(t, pass == 0 ? fl[kc] : fh[kc],
                       desc_sw128(tb + (kc >> 2) * (CW * SW_ROW) +
                                      (kc & 3) * 32,
                                  16),
                       pass + kc > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(t);
#pragma unroll
  for (int dt = 0; dt < 4; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) oc[dt][c] += t[dt][c];
}

// tf32_a_frags of p_eff: p with the dropout keep mask applied (bit 4 nt
// + c of keep for element c of block nt: p / (1 - rate) where kept, else
// 0), p left as it is for dS.
template <int NB, bool DROPOUT>
__device__ __forceinline__ void tf32_a_frags_kept(const float (&s)[NB][4],
                                                  uint32_t keep,
                                                  float inv_keep,
                                                  uint32_t (&hi)[NB][4],
                                                  uint32_t (&lo)[NB][4]) {
#pragma unroll
  for (int kc = 0; kc < NB; ++kc) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = (j >> 1) | ((j & 1) << 1);  // 0, 2, 1, 3
      float x = s[kc][c];
      if (DROPOUT) x = (keep >> (4 * kc + c)) & 1u ? x * inv_keep : 0.f;
      float h, l;
      tf32_split(x, h, l);
      hi[kc][j] = __float_as_uint(h);
      lo[kc][j] = __float_as_uint(l);
    }
  }
}

// dq: a CTA owns BM query rows. Per key tile, each ring's items are: C
// chunks of Q with K (S), C chunks of dO with V (dP), then C chunks of K
// again (dQ += dS . K, one 32-column block of dq each).
template <typename Tl, bool DROPOUT>
__device__ __forceinline__ void tf32_dq(
    const CUtensorMap* map_q, const CUtensorMap* map_do,
    const CUtensorMap* map_k, const CUtensorMap* map_v,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int sq, int sk, float sm_scale, int causal,
    uint32_t threshold, float keep_prob, DropKey seed) {
  constexpr int D = Tl::DIM, BM = Tl::BM, BN = Tl::BN, NB = Tl::NB;
  constexpr int CW = Tl::CW, C = Tl::CHUNKS, NS = Tl::NS;
  constexpr int ITEMS = 3 * C;  // ring items per key tile
  extern __shared__ unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t s0 = (base + SW_ATOM - 1) & ~(uint32_t)(SW_ATOM - 1);
  float4* xbuf = reinterpret_cast<float4*>(
      smem + (s0 - base) + Tl::RINGS * NS * Tl::STAGE_BYTES);
  float4* pbuf = xbuf + Tl::X_BYTES / 16;  // p while dP runs (P_STASH)
  // per ring and stage: the stage's copies landed
  __shared__ __align__(8) uint64_t full[Tl::RINGS][NS];

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, wtid = tid % WG_THREADS;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const GridCell cell = grid_cell((sq + BM - 1) / BM);
  const int m0 = cell.block * BM;
  const int bh = cell.bh;
  const int row_w = m0 + Tl::row0(wg) + warp * 16;  // this warp's first row
  const int qpos[2] = {row_w + g, row_w + g + 8};
  const float scale_log2 = sm_scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;
  const int col0 = Tl::col0(wg);  // this warpgroup's (and ring's) columns
  const uint32_t ring = s0 + Tl::ring(wg) * NS * Tl::STAGE_BYTES;
  // lse (in base 2) and delta of this thread's two rows, 0 past sq
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = qpos[r] < sq;
    lse2[r] = ok ? lse[(size_t)bh * sq + qpos[r]] * LOG2E : 0.f;
    dlt[r] = ok ? delta[(size_t)bh * sq + qpos[r]] : 0.f;
  }

  int n_tiles = (sk + BN - 1) / BN;
  if (causal)  // a K tile is live iff its first key is visible to the
               // CTA's last query (the reference's rule)
    n_tiles = min(n_tiles, (m0 + BM - 1) / BN + 1);
  const int n_items = n_tiles * ITEMS;

  auto stage = [&](int i) { return ring + (i % NS) * Tl::STAGE_BYTES; };
  auto bar = [&](int i) { return smem_u32(&full[Tl::ring(wg)][i % NS]); };
  // item i, issued by the ring's issuer: of key tile i / ITEMS, chunk j <
  // C of Q (every owned slot) and of K, chunk j - C < C of dO and of V, or
  // chunk j - 2C of K
  auto load_item = [&](int i) {
    const int t = i / ITEMS, j = i % ITEMS, c = j % C;
    const uint32_t st = stage(i), b = bar(i);
    if (j < 2 * C) {
      const bool second = j >= C;
      mbar_expect_tx(b, Tl::B_OFF + Tl::B_BYTES);
#pragma unroll
      for (int w = 0; w < Tl::A_SLOTS; ++w)
        tma_load_3d(st + w * Tl::A_BYTES, second ? map_do : map_q, b,
                    col0 + c * CW, m0 + w * WG_ROWS, bh);
      tma_load_3d(st + Tl::B_OFF, second ? map_v : map_k, b, col0 + c * CW,
                  t * BN, bh);
    } else {
      mbar_expect_tx(b, Tl::B_BYTES);
      tma_load_3d(st + Tl::B_OFF, map_k, b, col0 + c * CW, t * BN, bh);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < Tl::RINGS; ++w)
#pragma unroll
      for (int st = 0; st < NS; ++st) mbar_init(smem_u32(&full[w][st]), 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (Tl::issuer(wg, wtid))
    for (int i = 0; i < min(NS - 1, n_items); ++i) load_item(i);

  float acc[Tl::HALF / 8][4];  // this warpgroup's columns of dq
#pragma unroll
  for (int dt = 0; dt < Tl::HALF / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  int i = 0;
  auto next = [&] {  // item i + NS - 1, into the stage item i - 1 freed
    if (Tl::issuer(wg, wtid) && i + NS - 1 < n_items) load_item(i + NS - 1);
  };
  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BN;
    // S = Q . K^T, chunk by chunk, then summed (two sums a tile: S in
    // the first exchange buffer, dP in the second)
    float s[NB][4], dp[NB][4];
    float4* xs = score_buf<Tl>(xbuf, 0);
#pragma unroll 1
    for (int j = 0; j < C; ++j, ++i)
      tf32_score_item<Tl>(xs, stage(i), bar(i), (i / NS) & 1, j == 0, wg,
                          wtid, warp, g, tig, next);
    score_sum<Tl>(xs, wg, wtid, s);

    // p = 2^(s * sm_scale * log2(e) - lse * log2(e)), 0 where masked
    const bool edge = n0 + BN > sk || (causal && n0 + BN - 1 > row_w);
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        float p = exp2_approx(fmaf(s[nt][c], scale_log2, -lse2[r]));
        if (edge) {
          const int kpos = n0 + nt * 8 + tig * 2 + (c & 1);
          if (!(kpos < sk && (!causal || kpos <= qpos[r]))) p = 0.f;
        }
        s[nt][c] = p;
      }
    }

    // dP = dO . V^T, the same way
    if (Tl::P_STASH) exchange_store(pbuf, wg, wtid, s);
    float4* xdp = score_buf<Tl>(xbuf, 1);
#pragma unroll 1
    for (int j = 0; j < C; ++j, ++i)
      tf32_score_item<Tl>(xdp, stage(i), bar(i), (i / NS) & 1, j == 0, wg,
                          wtid, warp, g, tig, next);
    score_sum<Tl>(xdp, wg, wtid, dp);
    if (Tl::P_STASH) exchange_load(pbuf, wg, wtid, s);
    // ds = p * (dp_eff - delta) * sm_scale
    const uint32_t keep =
        DROPOUT ? keep_bits<NB>(n0, qpos, tig, bh, seed, threshold) : 0u;
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float dpv = dp[nt][c];
        if (DROPOUT) dpv = (keep >> (4 * nt + c)) & 1u ? dpv * inv_keep : 0.f;
        dp[nt][c] = s[nt][c] * (dpv - dlt[c >> 1]) * sm_scale;
      }
    }

    // dQ[:, this warpgroup's columns] += dS . K, chunk by chunk
    uint32_t dh[NB][4], dl[NB][4];
    tf32_a_frags(dp, dh, dl);
#pragma unroll
    for (int j = 0; j < C; ++j, ++i) {
      float(&oc)[4][4] = *reinterpret_cast<float(*)[4][4]>(&acc[4 * j][0]);
      tf32_grad_item<Tl>(oc, dh, dl, stage(i), bar(i), (i / NS) & 1, wg,
                         wtid, next);
    }
    fence_regs_u32(dh);
    fence_regs_u32(dl);
  }

  // dq: this thread's two rows, its warpgroup's columns, straight from
  // registers (two floats a thread per 8-column block)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= sq) continue;
    float* row = dq + ((size_t)bh * sq + qpos[r]) * D + col0 + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < Tl::HALF / 8; ++dt)
      *reinterpret_cast<float2*>(row + 8 * dt) =
          make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

// dk/dv: a CTA owns BM keys. Per query tile, each ring's items are, in
// one sweep for both outputs (Tl::ONE_SWEEP): C chunks of K with Q (s^T),
// C chunks of V with dO (dp^T), C chunks of dO (dV += P_eff^T . dO), then
// C chunks of Q (dK += dS^T . Q); else, in the dV sweep, C chunks of K
// with Q (s^T), then C chunks of dO, and in the dK sweep C chunks of K
// with Q, C chunks of V with dO, then C chunks of Q, the ring running on
// from one sweep into the next. Two sweeps compute s^T twice: 10 * d
// flops per kept pair for the function's 8 * d.
template <typename Tl, bool DROPOUT>
__device__ __forceinline__ void tf32_dkv(
    const CUtensorMap* map_q, const CUtensorMap* map_do,
    const CUtensorMap* map_k, const CUtensorMap* map_v,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
    float sm_scale, int causal, uint32_t threshold, float keep_prob,
    DropKey seed) {
  constexpr int D = Tl::DIM, BM = Tl::BM, BN = Tl::BN, NB = Tl::NB;
  constexpr int CW = Tl::CW, C = Tl::CHUNKS, NS = Tl::NS;
  constexpr bool ONE_SWEEP = Tl::ONE_SWEEP;
  // ring items per query tile: of the one sweep, of the dV sweep, of dK's
  constexpr int ITEMS_ONE = 4 * C, ITEMS1 = 2 * C, ITEMS2 = 3 * C;
  extern __shared__ unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t s0 = (base + SW_ATOM - 1) & ~(uint32_t)(SW_ATOM - 1);
  const uint32_t sX = s0 + Tl::RINGS * NS * Tl::STAGE_BYTES;
  float4* xbuf = reinterpret_cast<float4*>(smem + (sX - base));
  float4* pbuf = xbuf + Tl::X_BYTES / 16;  // p while dp^T runs (P_STASH)
  // by tile parity: lse, then delta
  const uint32_t sVec = sX + Tl::X_BYTES + Tl::P_BYTES;
  __shared__ __align__(8) uint64_t full[Tl::RINGS][NS];

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, wtid = tid % WG_THREADS;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const GridCell cell = grid_cell((sk + BM - 1) / BM);
  const int n0 = cell.block * BM;
  const int bh = cell.bh;
  const int key_w = n0 + Tl::row0(wg) + warp * 16;  // this warp's first key
  const int kpos[2] = {key_w + g, key_w + g + 8};
  const float scale_log2 = sm_scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;
  const int col0 = Tl::col0(wg);  // this warpgroup's (and ring's) columns
  const uint32_t ring = s0 + Tl::ring(wg) * NS * Tl::STAGE_BYTES;
  const float* lb = lse + (size_t)bh * sq;
  const float* deb = delta + (size_t)bh * sq;

  const int n_tiles = (sq + BN - 1) / BN;
  // causal: a q tile is live iff its last query can see the CTA's first
  // key
  const int first = causal ? n0 / BN : 0;
  const int count = max(n_tiles - first, 0);
  const int n_items = count * (ONE_SWEEP ? ITEMS_ONE : ITEMS1 + ITEMS2);

  auto stage = [&](int i) { return ring + (i % NS) * Tl::STAGE_BYTES; };
  auto bar = [&](int i) { return smem_u32(&full[Tl::ring(wg)][i % NS]); };
  // item i, issued by the ring's issuer: the sweep, the query tile and the
  // item within it, as listed above
  auto load_item = [&](int i) {
    bool sweep2 = true;  // the one sweep has dp^T and dK's items
    int t, j;
    if (ONE_SWEEP) {
      t = i / ITEMS_ONE;
      j = i % ITEMS_ONE;
    } else {
      sweep2 = i >= count * ITEMS1;
      const int i2 = sweep2 ? i - count * ITEMS1 : i;
      const int per = sweep2 ? ITEMS2 : ITEMS1;
      t = i2 / per;
      j = i2 % per;
    }
    const int m0 = (first + t) * BN, c = j % C;
    const uint32_t st = stage(i), b = bar(i);
    if (j < C || (sweep2 && j < 2 * C)) {  // K with Q, or V with dO
      const bool second = j >= C;
      mbar_expect_tx(b, Tl::B_OFF + Tl::B_BYTES);
#pragma unroll
      for (int w = 0; w < Tl::A_SLOTS; ++w)
        tma_load_3d(st + w * Tl::A_BYTES, second ? map_v : map_k, b,
                    col0 + c * CW, n0 + w * WG_ROWS, bh);
      tma_load_3d(st + Tl::B_OFF, second ? map_do : map_q, b, col0 + c * CW,
                  m0, bh);
    } else {  // dO (dV's items) or Q (dK's), to be transposed
      const bool q_item = ONE_SWEEP ? j >= 3 * C : sweep2;
      mbar_expect_tx(b, Tl::B_BYTES);
      tma_load_3d(st + Tl::B_OFF, q_item ? map_q : map_do, b, col0 + c * CW,
                  m0, bh);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < Tl::RINGS; ++w)
#pragma unroll
      for (int st = 0; st < NS; ++st) mbar_init(smem_u32(&full[w][st]), 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (Tl::issuer(wg, wtid))
    for (int i = 0; i < min(NS - 1, n_items); ++i) load_item(i);

  int i = 0;
  auto next = [&] {  // item i + NS - 1, into the stage item i - 1 freed
    if (Tl::issuer(wg, wtid) && i + NS - 1 < n_items) load_item(i + NS - 1);
  };
  int sums = 0;  // score sums so far (score_buf)
  // this warpgroup's columns of dv and of dk (two sweeps: one at a time,
  // in the same registers)
  float acc[ONE_SWEEP ? 2 : 1][Tl::HALF / 8][4];
  float(&accv)[Tl::HALF / 8][4] = acc[0];
  float(&acck)[Tl::HALF / 8][4] = acc[ONE_SWEEP ? 1 : 0];
  // a sweep over the live query tiles, its kind (mode's value) compiled
  // in: 0 takes dV, 1 dK, 2 both
  auto sweep = [&](auto mode) {
    constexpr int M = decltype(mode)::value;
    constexpr bool DV = M != 1, DK = M != 0;
#pragma unroll
    for (int dt = 0; dt < Tl::HALF / 8; ++dt) {
      if (DV) accv[dt][0] = accv[dt][1] = accv[dt][2] = accv[dt][3] = 0.f;
      if (DK) acck[dt][0] = acck[dt][1] = acck[dt][2] = acck[dt][3] = 0.f;
    }

    for (int t = 0; t < count; ++t) {
      const int it = (M == 1 ? count : 0) + t;
      const int m0 = (first + t) * BN;
      // the tile's lse and delta rows, in flight while s^T runs (the
      // buffer of this tile's parity was last read two tiles ago, before
      // a barrier that every thread of the CTA has passed since)
      const uint32_t vec = sVec + (it & 1) * 2 * BN * 4;
      load_vec_f32(vec, lb, m0, sq, BN, tid);
      load_vec_f32(vec + BN * 4, deb, m0, sq, BN, tid - BN);
      cp_async_commit();

      // s^T = K . Q^T, chunk by chunk, then summed (a barrier of the CTA
      // publishes lse and delta: the exchange's first, or the ring's)
      float s[NB][4], dp[NB][4];
      float4* xs = score_buf<Tl>(xbuf, sums++);
#pragma unroll 1
      for (int j = 0; j < C; ++j, ++i)
        tf32_score_item<Tl>(xs, stage(i), bar(i), (i / NS) & 1, j == 0, wg,
                            wtid, warp, g, tig, next);
      cp_async_wait<0>();
      if constexpr (!Tl::SPLIT_D) Tl::sync(wg);
      score_sum<Tl>(xs, wg, wtid, s);
      const float* sLse = reinterpret_cast<const float*>(smem + (vec - base));
      const float* sDelta = sLse + BN;

      // p = 2^(s * sm_scale * log2(e) - lse * log2(e)), 0 where masked, in
      // the transposed frame (fragment rows keys, columns queries); the dV
      // sweep keeps p_eff, the others p
      const bool edge = m0 + BN > sq || key_w + 16 > sk ||
                        (causal && key_w + 15 > m0);
      // the dropout keep mask, hashed where it is used (with dK: after
      // dp^T, so it holds no register while the products run)
      uint32_t keep =
          DROPOUT && M == 0
              ? keep_bits_t<NB>(m0, kpos, tig, bh, seed, threshold)
              : 0u;
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        const int col = nt * 8 + tig * 2;
        const float2 l2 = *reinterpret_cast<const float2*>(sLse + col);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = c & 1, r = c >> 1;
          const int qp = m0 + col + j;
          float p = exp2_approx(
              fmaf(s[nt][c], scale_log2, -(j ? l2.y : l2.x) * LOG2E));
          if (edge &&
              !(qp < sq && kpos[r] < sk && (!causal || kpos[r] <= qp)))
            p = 0.f;
          if (DROPOUT && M == 0)
            p = (keep >> (4 * nt + c)) & 1u ? p * inv_keep : 0.f;
          s[nt][c] = p;
        }
      }
      uint32_t fh[NB][4], fl[NB][4];
      if constexpr (DK) {
        // dp^T = V . dO^T, the same way
        if (Tl::P_STASH) exchange_store(pbuf, wg, wtid, s);
        float4* xdp = score_buf<Tl>(xbuf, sums++);
#pragma unroll 1
        for (int j = 0; j < C; ++j, ++i)
          tf32_score_item<Tl>(xdp, stage(i), bar(i), (i / NS) & 1, j == 0,
                              wg, wtid, warp, g, tig, next);
        score_sum<Tl>(xdp, wg, wtid, dp);
        // hashed while p is parked in shared memory (above d 320): the
        // hash's temporaries then share the registers with dp^T alone
        if (DROPOUT)
          keep = keep_bits_t<NB>(m0, kpos, tig, bh, seed, threshold);
        if (Tl::P_STASH) exchange_load(pbuf, wg, wtid, s);
        // with dV: P_eff's fragments, before ds takes p's registers
        if constexpr (DV)
          tf32_a_frags_kept<NB, DROPOUT>(s, keep, inv_keep, fh, fl);
        // ds = p * (dp_eff - delta) * sm_scale, into s
#pragma unroll
        for (int nt = 0; nt < NB; ++nt) {
          const float2 del2 =
              *reinterpret_cast<const float2*>(sDelta + nt * 8 + tig * 2);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float dpv = dp[nt][c];
            if (DROPOUT)
              dpv = (keep >> (4 * nt + c)) & 1u ? dpv * inv_keep : 0.f;
            s[nt][c] =
                s[nt][c] * (dpv - ((c & 1) ? del2.y : del2.x)) * sm_scale;
          }
        }
        if constexpr (DV) {
          // dV[:, own columns] += P_eff^T . dO, chunk by chunk
#pragma unroll
          for (int j = 0; j < C; ++j, ++i) {
            float(&oc)[4][4] =
                *reinterpret_cast<float(*)[4][4]>(&accv[4 * j][0]);
            tf32_grad_item<Tl>(oc, fh, fl, stage(i), bar(i), (i / NS) & 1,
                               wg, wtid, next);
          }
          fence_regs_u32(fh);
          fence_regs_u32(fl);
        }
      }

      // dV[:, own columns] += P_eff^T . dO (the dV sweep), or dK[:, own
      // columns] += dS^T . Q, chunk by chunk
      tf32_a_frags(s, fh, fl);
#pragma unroll
      for (int j = 0; j < C; ++j, ++i) {
        float(&oc)[4][4] = *reinterpret_cast<float(*)[4][4]>(
            DK ? &acck[4 * j][0] : &accv[4 * j][0]);
        tf32_grad_item<Tl>(oc, fh, fl, stage(i), bar(i), (i / NS) & 1, wg,
                           wtid, next);
      }
      fence_regs_u32(fh);
      fence_regs_u32(fl);
    }

    // this sweep's outputs: this thread's two keys, its warpgroup's
    // columns
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kpos[r] >= sk) continue;
      const size_t off = ((size_t)bh * sk + kpos[r]) * D + col0 + 2 * tig;
#pragma unroll
      for (int dt = 0; dt < Tl::HALF / 8; ++dt) {
        if (DV)
          *reinterpret_cast<float2*>(dv + off + 8 * dt) =
              make_float2(accv[dt][2 * r], accv[dt][2 * r + 1]);
        if (DK)
          *reinterpret_cast<float2*>(dk + off + 8 * dt) =
              make_float2(acck[dt][2 * r], acck[dt][2 * r + 1]);
      }
    }
  };
  if constexpr (ONE_SWEEP) {
    sweep(std::integral_constant<int, 2>());  // dV and dK
  } else {
    sweep(std::integral_constant<int, 0>());  // dV
    sweep(std::integral_constant<int, 1>());  // dK
  }
}

// The kernels, laid out by Tf32BwdTiles: at d 192 ... 512 D split between
// two warpgroups over 64 rows; at d 64 and 128 two warpgroups of 64 rows
// each.
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(Tf32BwdTiles<D>::THREADS, 1)
    flash_bwd_dq_wgmma_wide_tf32_kernel(
        const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_do,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dq, int sq, int sk, float sm_scale, int causal,
        uint32_t threshold, float keep_prob, DropKey seed) {
  tf32_dq<Tf32BwdTiles<D>, DROPOUT>(&tm_q, &tm_do, &tm_k, &tm_v, lse, delta,
                                    dq, sq, sk, sm_scale, causal, threshold,
                                    keep_prob, seed);
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(Tf32BwdTiles<D>::THREADS, 1)
    flash_bwd_dkv_wgmma_wide_tf32_kernel(
        const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_do,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
        float sm_scale, int causal, uint32_t threshold, float keep_prob,
        DropKey seed) {
  tf32_dkv<Tf32BwdTiles<D>, DROPOUT>(&tm_q, &tm_do, &tm_k, &tm_v, lse,
                                     delta, dk, dv, sq, sk, sm_scale, causal,
                                     threshold, keep_prob, seed);
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(Tf32BwdTiles<D>::THREADS, 1)
    flash_bwd_dq_wgmma_tf32_kernel(
        const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_do,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dq, int sq, int sk, float sm_scale, int causal,
        uint32_t threshold, float keep_prob, DropKey seed) {
  tf32_dq<Tf32BwdTiles<D>, DROPOUT>(&tm_q, &tm_do, &tm_k, &tm_v, lse, delta,
                                    dq, sq, sk, sm_scale, causal, threshold,
                                    keep_prob, seed);
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(Tf32BwdTiles<D>::THREADS, 1)
    flash_bwd_dkv_wgmma_tf32_kernel(
        const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_do,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
        float sm_scale, int causal, uint32_t threshold, float keep_prob,
        DropKey seed) {
  tf32_dkv<Tf32BwdTiles<D>, DROPOUT>(&tm_q, &tm_do, &tm_k, &tm_v, lse,
                                     delta, dk, dv, sq, sk, sm_scale, causal,
                                     threshold, keep_prob, seed);
}

// Launch one of the kernels above, laid out by Tl: the tensor maps (the
// owned rows' boxes a warpgroup's 64 rows, the streamed ones BN), the
// grid over the row blocks of every b*h; causal dq's heaviest blocks
// first where its heads' K/V fit L2; causal dk/dv's heaviest are its
// first anyway.
template <typename Tl, bool DKV, typename Kernel>
cudaError_t launch_tf32_bwd(Kernel kernel, const Args& a,
                            unsigned long long* smem_set) {
  constexpr int D = Tl::DIM;
  cudaError_t err = allow_smem(kernel, Tl::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int q_rows = DKV ? Tl::BN : WG_ROWS, k_rows = DKV ? WG_ROWS : Tl::BN;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if ((err = tensor_map_f32(&tm_q, a.q, a.bh, a.sq, D, q_rows)) !=
          cudaSuccess ||
      (err = tensor_map_f32(&tm_do, a.dout, a.bh, a.sq, D, q_rows)) !=
          cudaSuccess ||
      (err = tensor_map_f32(&tm_k, a.k, a.bh, a.sk, D, k_rows)) !=
          cudaSuccess ||
      (err = tensor_map_f32(&tm_v, a.v, a.bh, a.sk, D, k_rows)) !=
          cudaSuccess)
    return err;
  dim3 grid;
  const bool ok =
      DKV ? launch_grid((a.sk + Tl::BM - 1) / Tl::BM, a.bh, 1, false, 0,
                        &grid)
          : launch_grid((a.sq + Tl::BM - 1) / Tl::BM, a.bh, 1, a.causal,
                        2LL * a.sk * D * sizeof(float), &grid);
  if (!ok) return cudaErrorInvalidValue;
  if constexpr (DKV)
    kernel<<<grid, Tl::THREADS, Tl::SMEM, a.stream>>>(
        tm_q, tm_do, tm_k, tm_v, a.lse, a.delta,
        static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.sq, a.sk,
        a.sm_scale, a.causal, a.threshold, a.keep_prob, a.seed);
  else
    kernel<<<grid, Tl::THREADS, Tl::SMEM, a.stream>>>(
        tm_q, tm_do, tm_k, tm_v, a.lse, a.delta,
        static_cast<float*>(a.out0), a.sq, a.sk, a.sm_scale, a.causal,
        a.threshold, a.keep_prob, a.seed);
  return cudaGetLastError();
}

template <int D, bool DROPOUT>
cudaError_t launch_dq_tf32_wide_t(const Args& a) {
  auto kernel = flash_bwd_dq_wgmma_wide_tf32_kernel<D, DROPOUT>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  return launch_tf32_bwd<Tf32BwdTiles<D>, false>(kernel, a, &smem_set);
}

template <int D>
cudaError_t launch_dq_tf32_wide(const Args& a) {
  return a.use_dropout ? launch_dq_tf32_wide_t<D, true>(a)
                       : launch_dq_tf32_wide_t<D, false>(a);
}

template <int D, bool DROPOUT>
cudaError_t launch_dkv_tf32_wide_t(const Args& a) {
  auto kernel = flash_bwd_dkv_wgmma_wide_tf32_kernel<D, DROPOUT>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  return launch_tf32_bwd<Tf32BwdTiles<D>, true>(kernel, a, &smem_set);
}

template <int D>
cudaError_t launch_dkv_tf32_wide(const Args& a) {
  return a.use_dropout ? launch_dkv_tf32_wide_t<D, true>(a)
                       : launch_dkv_tf32_wide_t<D, false>(a);
}

template <int D, bool DROPOUT>
cudaError_t launch_dq_tf32_t(const Args& a) {
  auto kernel = flash_bwd_dq_wgmma_tf32_kernel<D, DROPOUT>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  return launch_tf32_bwd<Tf32BwdTiles<D>, false>(kernel, a, &smem_set);
}

template <int D>
cudaError_t launch_dq_tf32(const Args& a) {
  return a.use_dropout ? launch_dq_tf32_t<D, true>(a)
                       : launch_dq_tf32_t<D, false>(a);
}

template <int D, bool DROPOUT>
cudaError_t launch_dkv_tf32_t(const Args& a) {
  auto kernel = flash_bwd_dkv_wgmma_tf32_kernel<D, DROPOUT>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  return launch_tf32_bwd<Tf32BwdTiles<D>, true>(kernel, a, &smem_set);
}

template <int D>
cudaError_t launch_dkv_tf32(const Args& a) {
  return a.use_dropout ? launch_dkv_tf32_t<D, true>(a)
                       : launch_dkv_tf32_t<D, false>(a);
}

// ---------------------------------------------------------------------------
// bf16 at d <= 32: the narrow dq and dk/dv kernels
// ---------------------------------------------------------------------------
// Replace the TPU kernels _bwd_dq_kernel and _bwd_dkv_kernel (flexflow_tpu/
// kernels/flash_attention.py:169, :210) at head dims up to 32 in bf16 (the
// Transformer's heads of d = 8), as flash_fwd_wgmma_narrow_kernel replaces
// the forward there. Padded to d = 64, the d <= 128 kernels spend 8x the
// tensor work and the tile bytes on zero columns at d = 8, after four host
// pads of q, k, v and dO. Bound at b64 h8 s512 d8: each kernel rebuilds p,
// 134 M exponentials, one MUFU ex2 each at 16 per SM per clock (~32 us at
// 1.98 GHz), where the bytes (q, k, v, do, lse, delta, the outputs) take
// 6-7 us at 3.35 TB/s and the products 0.5-0.7 GFLOP: as in the narrow
// forward, the exponentials are the work.
//
// Design. The narrow forward's tiles: rows of DP = d rounded up to 16 or
// 32 bf16 columns (32 or 64 bytes) in the 32- or 64-byte swizzle, 64-row
// tiles, one warpgroup per CTA and four CTAs an SM (at most 128 registers
// a thread), so one CTA's exponentials run while another waits on its
// products or its copies. The score products S = Q . K^T and dP = dO .
// V^T (transposed in dk/dv) are m64n64k16 with both operands K-major,
// DP / 16 steps each, in two commit groups, so the exponentials of S run
// while dP is on the tensor cores; the gradient products take dS (and
// P_eff) rounded to bf16 in registers as the A operand and read their B
// tile MN-major, m64nDPk16 (the forward's P . V shape), into 64 x DP f32
// accumulators of DP / 2 registers a thread, waited for in their own
// iteration. Streamed tiles come through rings of three stages, each copy
// issued two tiles ahead. Mask, dropout bits and the base-2 exponent are
// the d <= 128 kernels'; delta is taken times sm_scale (and 1 / keep_prob
// folded into the multiplier of dp), so ds = p * (dp * c - delta') is an
// FFMA and an FMUL.
//   - dq (flash_bwd_dq_wgmma_narrow_kernel): a CTA owns 64 query rows, Q
//     and dO resident; K and V tiles of 64 keys come by TMA, the tensor
//     maps over the true (bh, s, d) tensors with DP-column boxes (a load
//     zero-fills the columns past d).
//   - dk/dv (flash_bwd_dkv_wgmma_narrow_kernel): a CTA owns 64 keys, K and
//     V resident; Q and dO tiles of 64 queries with their lse and delta
//     come by cp.async (lse and delta rows of sq floats are not 16-byte
//     aligned in general, which TMA needs), each thread turning its own
//     lse and delta entry into -lse * log2(e) and delta * sm_scale as the
//     tile lands. Its two 64 x DP accumulators, where the d = 64 kernel
//     holds two 64 x 64 ones, are what let four CTAs fit an SM (three at
//     DP = 32 with dropout, below).
// On an NVIDIA H100 80GB HBM3 at 700 W, b64 h8 s512 d8 (PERF.md sec. 6),
// three changes counted: the mask's compares in their own copy of the
// exponential loop, run only in the tiles at an edge (written as one loop
// with the test inside, ptxas computed the compares for every score of
// every tile: dk/dv 129.49 -> 80.80 us; before it, dk/dv without its
// exponentials took the same time); dq's gradient product waited for in
// its own iteration (deferred to the next tile's score wait, ptxas
// serialized every wgmma of the kernel: 77.27 -> 72.25 us); the folded
// scales and the third stage (dq 81.60 -> 77.18 us, serialized).
// dq, dk and dv are written by bf16 pair stores at their true d columns
// only. Two kernels rather than one fused backward, which would compute
// the exponentials once: a fused kernel sums dq across key blocks with
// atomics, and dq would no longer give the same bits on every launch.
template <int DP>
struct BwdNarrowTiles {
  static_assert(DP == 16 || DP == 32, "16 or 32 columns");
  static constexpr int ROWS = WG_ROWS;  // rows a CTA owns (queries; keys)
  static constexpr int BN = 64;         // rows of a streamed tile
  static constexpr int NB = BN / 8;     // 8-column blocks of a score tile
  static constexpr int ROW = DP * 2;    // bytes of a tile row
  static constexpr int ATOM = 8 * ROW;  // an 8-row swizzle atom
  static constexpr uint32_t MODE = DP == 16 ? 3 : 2;  // 32- or 64-byte
  static constexpr int TILE_BYTES = 64 * ROW;  // every tile has 64 rows
  // stages of the rings: each copy is issued STAGES - 1 tiles ahead
  static constexpr int STAGES = 3;
  // dq: Q and dO, then rings for K and for V
  static constexpr size_t DQ_SMEM = SW_ATOM + (2 + 2 * STAGES) * TILE_BYTES;
  // dk/dv: a stage holds a Q and a dO tile, then lse and delta (64 floats
  // each), padded so the next stage's tiles stay 1024-byte aligned; K and
  // V, then the ring
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + SW_ATOM;
  static constexpr size_t DKV_SMEM =
      SW_ATOM + 2 * TILE_BYTES + STAGES * STAGE_BYTES;
  static_assert(TILE_BYTES % SW_ATOM == 0, "tiles stay 1024-byte aligned");
};

template <int DP, bool DROPOUT>
__global__ void __launch_bounds__(WG_THREADS, 4)
    flash_bwd_dq_wgmma_narrow_kernel(
        const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_do,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dq, int sq, int sk, int d,
        float sm_scale, int causal, uint32_t threshold, float keep_prob,
        DropKey seed) {
  using Tl = BwdNarrowTiles<DP>;
  constexpr int BM = Tl::ROWS, BN = Tl::BN, NB = Tl::NB;
  constexpr int ROW = Tl::ROW, ATOM = Tl::ATOM, TB = Tl::TILE_BYTES;
  constexpr uint32_t MODE = Tl::MODE;
  extern __shared__ unsigned char smem[];
  const uint32_t sQ =
      (smem_u32(smem) + SW_ATOM - 1) & ~(uint32_t)(SW_ATOM - 1);
  const uint32_t sDO = sQ + TB;
  constexpr int ST = Tl::STAGES;
  const uint32_t sKs = sDO + TB;       // K ring
  const uint32_t sVs = sKs + ST * TB;  // V ring
  // per stage: the K tile (and, first, Q and dO) landed; the V tile landed
  __shared__ __align__(8) uint64_t k_full[ST], v_full[ST];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const GridCell cell = grid_cell((sq + BM - 1) / BM);
  const int m0 = cell.block * BM;
  const int bh = cell.bh;
  const int row_w = m0 + warp * 16;  // this warp's first query row
  const int qpos[2] = {row_w + g, row_w + g + 8};
  const float scale_log2 = sm_scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;
  const float keep_scale = sm_scale * inv_keep;
  // lse (in base 2) and delta * sm_scale of this thread's two rows, 0
  // past sq
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = qpos[r] < sq;
    lse2[r] = ok ? lse[(size_t)bh * sq + qpos[r]] * LOG2E : 0.f;
    dlt[r] = ok ? delta[(size_t)bh * sq + qpos[r]] * sm_scale : 0.f;
  }

  int n_tiles = (sk + BN - 1) / BN;
  if (causal)  // a K tile is live iff its first key is visible to the
               // CTA's last query (the reference's rule)
    n_tiles = min(n_tiles, (m0 + BM - 1) / BN + 1);

  auto k_stage = [&](int t) { return sKs + (t % ST) * TB; };
  auto v_stage = [&](int t) { return sVs + (t % ST) * TB; };
  auto k_bar = [&](int t) { return smem_u32(&k_full[t % ST]); };
  auto v_bar = [&](int t) { return smem_u32(&v_full[t % ST]); };
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load_kv = [&](int t, int extra_bytes) {  // by thread 0
    mbar_expect_tx(k_bar(t), TB + extra_bytes);
    tma_load_3d(k_stage(t), map_k, k_bar(t), 0, t * BN, bh);
    mbar_expect_tx(v_bar(t), TB);
    tma_load_3d(v_stage(t), map_v, v_bar(t), 0, t * BN, bh);
  };

  // The ring: Q and dO join K tile 0's phase, then K/V tiles 0 ... ST -
  // 1. K tile t is last read by dQ(t), which completes with S(t + 1), so
  // the barrier after that wait in iteration t + 1 starts the copy of K/V
  // tile t + ST into its stage (V tile t was released with dP(t)).
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      mbar_init(k_bar(st), 1);
      mbar_init(v_bar(st), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_kv(0, 2 * TB);
    tma_load_3d(sQ, &tm_q, k_bar(0), 0, m0, bh);
    tma_load_3d(sDO, &tm_do, k_bar(0), 0, m0, bh);
    for (int t = 1; t < ST && t < n_tiles; ++t) load_kv(t, 0);
  }

  float acc[DP / 8][4];  // the 64 x DP of dq
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BN;
    const uint32_t sK = k_stage(t), sV = v_stage(t);

    // S = Q . K^T, then, once V lands, dP = dO . V^T: DP / 16 steps each,
    // both operands K-major, one commit group each
    float s[NB][4], dp[NB][4];
    mbar_wait(k_bar(t), (t / ST) & 1);  // K tile t (and Q, dO) landed
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc)
      wgmma_ss_m64n64k16(acc_block(s, 0),
                         desc_sw(sQ + kc * 32, 16, ATOM, MODE),
                         desc_sw(sK + kc * 32, 16, ATOM, MODE), kc > 0);
    wgmma_commit();
    mbar_wait(v_bar(t), (t / ST) & 1);  // V tile t landed
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc)
      wgmma_ss_m64n64k16(acc_block(dp, 0),
                         desc_sw(sDO + kc * 32, 16, ATOM, MODE),
                         desc_sw(sV + kc * 32, 16, ATOM, MODE), kc > 0);
    wgmma_commit();
    // the dropout mask, hashed while the products run
    const uint32_t keep =
        DROPOUT ? keep_bits(n0, qpos, tig, bh, seed, threshold) : 0u;
    const bool edge = n0 + BN > sk || (causal && n0 + BN - 1 > row_w);

    wgmma_wait<1>();  // S(t); dP(t) may still run
    fence_acc(s);
    __syncthreads();  // every warp is done with K tile t - 1
    if (tid == 0 && t >= 1 && t + ST - 1 < n_tiles) load_kv(t + ST - 1, 0);

    // p = 2^(s * sm_scale * log2(e) - lse * log2(e)), 0 where masked
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        float p = exp2_approx(fmaf(s[nt][c], scale_log2, -lse2[r]));
        if (edge) {
          const int kpos = n0 + nt * 8 + tig * 2 + (c & 1);
          if (!(kpos < sk && (!causal || kpos <= qpos[r]))) p = 0.f;
        }
        s[nt][c] = p;
      }
    }
    // ds = p * (dp_eff - delta) * sm_scale, as p * (dp * sm_scale (/
    // keep_prob where kept, 0 where dropped) - delta * sm_scale)
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float sc = sm_scale;
        if (DROPOUT) sc = (keep >> (4 * nt + c)) & 1u ? keep_scale : 0.f;
        dp[nt][c] = s[nt][c] * fmaf(dp[nt][c], sc, -dlt[c >> 1]);
      }
    }

    // dQ += dS . K: dS rounded to bf16 in registers, K read MN-major from
    // the staged tile, 16 keys a step
    uint32_t da[NB / 2][4];
    to_a_frags(dp, da);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < NB / 2; ++kc)
      wgmma_rs_kk<DP / 8, 1>(acc, da[kc],
                             desc_sw(sK + kc * 16 * ROW, TB, ATOM, MODE), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs_u32(da);
    fence_acc(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= sq) continue;
    __nv_bfloat16* out = dq + ((size_t)bh * sq + qpos[r]) * d + tig * 2;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
      if (dt * 8 < d) store2(out + dt * 8, acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

// Four CTAs an SM, except at DP = 32 with dropout: there the two 64 x 32
// accumulators, the two score tiles and the keep bits spill 16 bytes at
// 128 registers (ptxas on the H100's toolkit), and a wgmma kernel must not
// spill, so that instantiation takes three.
template <int DP, bool DROPOUT>
__global__ void __launch_bounds__(WG_THREADS, DP == 32 && DROPOUT ? 3 : 4)
    flash_bwd_dkv_wgmma_narrow_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        int sq, int sk, int d, float sm_scale, int causal,
        uint32_t threshold, float keep_prob, DropKey seed) {
  using Tl = BwdNarrowTiles<DP>;
  constexpr int BN = Tl::ROWS, BM = Tl::BN, NB = Tl::NB;  // keys; queries
  constexpr int ST = Tl::STAGES;
  constexpr int ROW = Tl::ROW, ATOM = Tl::ATOM, TB = Tl::TILE_BYTES;
  constexpr uint32_t MODE = Tl::MODE;
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t sK = (raw + SW_ATOM - 1) & ~(uint32_t)(SW_ATOM - 1);
  const uint32_t sV = sK + TB;
  const uint32_t sRing = sV + TB;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const GridCell cell = grid_cell((sk + BN - 1) / BN);
  const int n0 = cell.block * BN;
  const int bh = cell.bh;
  const __nv_bfloat16* qb = q + (size_t)bh * sq * d;
  const __nv_bfloat16* db = dout + (size_t)bh * sq * d;
  const float* lb = lse + (size_t)bh * sq;
  const float* deb = delta + (size_t)bh * sq;
  const int key_w = n0 + warp * 16;  // this warp's first key
  const int kpos[2] = {key_w + g, key_w + g + 8};
  const float scale_log2 = sm_scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;
  const float keep_scale = sm_scale * inv_keep;

  const int n_tiles = (sq + BM - 1) / BM;
  // causal: a q tile is live iff its last query can see the first key
  const int first = causal ? n0 / BM : 0;
  const int count = n_tiles - first;

  auto load_q = [&](int i) {
    const int m0 = (first + i) * BM;
    const uint32_t st = sRing + (i % ST) * Tl::STAGE_BYTES;
    load_tile_narrow<BM, DP, WG_THREADS>(st, qb, m0, sq, d, tid);
    load_tile_narrow<BM, DP, WG_THREADS>(st + TB, db, m0, sq, d, tid);
    load_vec_f32(st + 2 * TB, lb, m0, sq, BM, tid);
    load_vec_f32(st + 2 * TB + BM * 4, deb, m0, sq, BM, tid - BM);
  };
  // the ring: K, V and q tile 0 in one commit group, q tiles 1 ... ST - 2
  // one group each; then, after the barrier that frees its stage, each
  // iteration i starts the copy of q tile i + ST - 1 (a group, empty past
  // the last tile, so the count of groups in flight stays ST - 2)
  load_tile_narrow<BN, DP, WG_THREADS>(sK, k + (size_t)bh * sk * d, n0, sk,
                                       d, tid);
  load_tile_narrow<BN, DP, WG_THREADS>(sV, v + (size_t)bh * sk * d, n0, sk,
                                       d, tid);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < count) load_q(i);
    cp_async_commit();
  }

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];  // the 64 x DP of dk, dv
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    dk_acc[dt][0] = dk_acc[dt][1] = dk_acc[dt][2] = dk_acc[dt][3] = 0.f;
    dv_acc[dt][0] = dv_acc[dt][1] = dv_acc[dt][2] = dv_acc[dt][3] = 0.f;
  }

  for (int i = 0; i < count; ++i) {
    const int m0 = (first + i) * BM;
    const uint32_t sQ = sRing + (i % ST) * Tl::STAGE_BYTES;
    const uint32_t sDO = sQ + TB;
    float* sLse = reinterpret_cast<float*>(smem + (sQ + 2 * TB - raw));
    const float* sDelta = sLse + BM;
    cp_async_wait<ST - 2>();  // K, V and q tile i have landed
    // this thread's own copy of the tile's lse and delta (entry tid of
    // the two), made -lse * log2(e) and delta * sm_scale: each score then
    // takes one FFMA before its exponential and one FFMA and one FMUL
    // after
    sLse[tid] = tid < BM ? -sLse[tid] * LOG2E : sLse[tid] * sm_scale;
    fence_proxy_async();
    __syncthreads();  // ... for every thread, and every warp is done with
                      // the stage the next copy overwrites
    if (i + ST - 1 < count) load_q(i + ST - 1);
    cp_async_commit();

    // the dropout keep mask of this thread's fragment (bit 4 * nt + c),
    // hashed before the products so its temporaries and the score
    // accumulators are never live together
    const uint32_t keep =
        DROPOUT ? keep_bits_t<NB>(m0, kpos, tig, bh, seed, threshold) : 0u;

    // s^T = K . Q^T and dp^T = V . dO^T for the CTA's 64 keys, one commit
    // group each
    float s[NB][4], dp[NB][4];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc)
      wgmma_ss_m64n64k16(acc_block(s, 0),
                         desc_sw(sK + kc * 32, 16, ATOM, MODE),
                         desc_sw(sQ + kc * 32, 16, ATOM, MODE), kc > 0);
    wgmma_commit();
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc)
      wgmma_ss_m64n64k16(acc_block(dp, 0),
                         desc_sw(sV + kc * 32, 16, ATOM, MODE),
                         desc_sw(sDO + kc * 32, 16, ATOM, MODE), kc > 0);
    wgmma_commit();
    const bool edge = m0 + BM > sq || key_w + 16 > sk ||
                      (causal && key_w + 15 > m0);

    // p = 2^(s * sm_scale * log2(e) - lse * log2(e)) in the transposed
    // frame (fragment rows are keys, columns queries), while dP^T runs
    wgmma_wait<1>();
    fence_acc(s);
    // (two copies of the loop, so the mask's compares run only in the
    // tiles at an edge)
    auto exp_tile = [&](auto masked) {
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        const int col = nt * 8 + tig * 2;
        const float2 nlse = *reinterpret_cast<const float2*>(sLse + col);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = c & 1, r = c >> 1;
          float p = exp2_approx(
              fmaf(s[nt][c], scale_log2, j ? nlse.y : nlse.x));
          if constexpr (decltype(masked)::value) {
            const int qp = m0 + col + j;
            if (!(qp < sq && kpos[r] < sk && (!causal || kpos[r] <= qp)))
              p = 0.f;
          }
          s[nt][c] = p;
        }
      }
    };
    if (edge)
      exp_tile(std::true_type());
    else
      exp_tile(std::false_type());
    // p_eff and ds = p * (dp_eff - delta) * sm_scale, as p * (dp *
    // sm_scale (/ keep_prob where kept, 0 where dropped) - delta *
    // sm_scale)
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
      const float2 del_c =
          *reinterpret_cast<const float2*>(sDelta + nt * 8 + tig * 2);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = s[nt][c];
        float sc = sm_scale, pe = p;
        if (DROPOUT) {
          const bool kept = (keep >> (4 * nt + c)) & 1u;
          sc = kept ? keep_scale : 0.f;
          pe = kept ? p * inv_keep : 0.f;
        }
        s[nt][c] = pe;
        dp[nt][c] =
            p * fmaf(dp[nt][c], sc, -((c & 1) ? del_c.y : del_c.x));
      }
    }

    // dV += P_eff^T . dO and dK += dS^T . Q: the fragments rounded to bf16
    // in registers, dO and Q read MN-major from the staged tiles, 16
    // queries a step
    uint32_t pa[NB / 2][4], da[NB / 2][4];
    to_a_frags(s, pa);
    to_a_frags(dp, da);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < NB / 2; ++kc)
      wgmma_rs_kk<DP / 8, 1>(dv_acc, pa[kc],
                             desc_sw(sDO + kc * 16 * ROW, TB, ATOM, MODE), 1);
#pragma unroll
    for (int kc = 0; kc < NB / 2; ++kc)
      wgmma_rs_kk<DP / 8, 1>(dk_acc, da[kc],
                             desc_sw(sQ + kc * 16 * ROW, TB, ATOM, MODE), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs_u32(pa);
    fence_regs_u32(da);
    fence_acc(dv_acc);
    fence_acc(dk_acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= sk) continue;
    const size_t off = ((size_t)bh * sk + kpos[r]) * d + tig * 2;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      if (dt * 8 >= d) continue;
      store2(dk + off + dt * 8, dk_acc[dt][2 * r], dk_acc[dt][2 * r + 1]);
      store2(dv + off + dt * 8, dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

template <int DP, bool DROPOUT>
cudaError_t launch_dq_narrow_t(const Args& a, int d) {
  using Tl = BwdNarrowTiles<DP>;
  auto kernel = flash_bwd_dq_wgmma_narrow_kernel<DP, DROPOUT>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, Tl::DQ_SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  const CUtensorMapSwizzle swz =
      DP == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if ((err = tensor_map_bf16(&tm_q, a.q, a.bh, a.sq, d, Tl::ROWS, DP,
                             swz)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_do, a.dout, a.bh, a.sq, d, Tl::ROWS, DP,
                             swz)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_k, a.k, a.bh, a.sk, d, Tl::BN, DP, swz)) !=
          cudaSuccess ||
      (err = tensor_map_bf16(&tm_v, a.v, a.bh, a.sk, d, Tl::BN, DP, swz)) !=
          cudaSuccess)
    return err;
  dim3 grid;
  if (!launch_grid((a.sq + Tl::ROWS - 1) / Tl::ROWS, a.bh, 1, a.causal,
                   2LL * a.sk * d * sizeof(__nv_bfloat16), &grid))
    return cudaErrorInvalidValue;
  kernel<<<grid, WG_THREADS, Tl::DQ_SMEM, a.stream>>>(
      tm_q, tm_do, tm_k, tm_v, a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.out0), a.sq, a.sk, d, a.sm_scale,
      a.causal, a.threshold, a.keep_prob, a.seed);
  return cudaGetLastError();
}

template <int DP, bool DROPOUT>
cudaError_t launch_dkv_narrow_t(const Args& a, int d) {
  using Tl = BwdNarrowTiles<DP>;
  auto kernel = flash_bwd_dkv_wgmma_narrow_kernel<DP, DROPOUT>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, Tl::DKV_SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid;  // causal dk/dv's heaviest key blocks are its first
  if (!launch_grid((a.sk + Tl::ROWS - 1) / Tl::ROWS, a.bh, 1, false, 0,
                   &grid))
    return cudaErrorInvalidValue;
  kernel<<<grid, WG_THREADS, Tl::DKV_SMEM, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.out0), static_cast<__nv_bfloat16*>(a.out1),
      a.sq, a.sk, d, a.sm_scale, a.causal, a.threshold, a.keep_prob, a.seed);
  return cudaGetLastError();
}

// DP: d rounded up to 16 or 32 (d a multiple of 8, TMA's 16-byte rows)
template <int DP>
cudaError_t launch_dq_narrow(const Args& a, int d) {
  return a.use_dropout ? launch_dq_narrow_t<DP, true>(a, d)
                       : launch_dq_narrow_t<DP, false>(a, d);
}

template <int DP>
cudaError_t launch_dkv_narrow(const Args& a, int d) {
  return a.use_dropout ? launch_dkv_narrow_t<DP, true>(a, d)
                       : launch_dkv_narrow_t<DP, false>(a, d);
}

int dispatch(bool dkv, int dtype, int head_dim, const Args& a) {
  if (a.bh <= 0 || a.sq <= 0 || a.sk <= 0 || head_dim <= 0)
    return (int)cudaErrorInvalidValue;
  // bf16 runs the wgmma kernels, f32 the split-precision TF32 wgmma
  // kernels (three passes a product, d compiled in); bf16 at d = 8, 16, 24
  // and 32 the narrow wgmma kernels (d unpadded); d = 192 ... 512 the wide
  // wgmma kernels (d compiled in); above 512 either type the wide FMA
  // kernels (d a runtime argument)
  using bf16 = __nv_bfloat16;
#define FF_LAUNCH_NARROW(DP)                                       \
  return (int)(dkv ? launch_dkv_narrow<DP>(a, head_dim)            \
                   : launch_dq_narrow<DP>(a, head_dim))
  if (dtype == 1 && head_dim % 8 == 0 && head_dim <= 16)
    FF_LAUNCH_NARROW(16);
  if (dtype == 1 && head_dim % 8 == 0 && head_dim <= 32)
    FF_LAUNCH_NARROW(32);
#undef FF_LAUNCH_NARROW
  if (!dkv && dtype == 1) switch (head_dim) {
      case 192: return (int)launch_dq_wgmma_wide<192>(a);
      case 256: return (int)launch_dq_wgmma_wide<256>(a);
      case 320: return (int)launch_dq_wgmma_wide<320>(a);
      case 384: return (int)launch_dq_wgmma_wide<384>(a);
      case 448: return (int)launch_dq_wgmma_wide<448>(a);
      case 512: return (int)launch_dq_wgmma_wide<512>(a);
      default: break;
    }
  if (dkv && dtype == 1) switch (head_dim) {
      case 192: return (int)launch_dkv_wgmma_wide<192>(a);
      case 256: return (int)launch_dkv_wgmma_wide<256>(a);
      case 320: return (int)launch_dkv_wgmma_wide<320>(a);
      case 384: return (int)launch_dkv_wgmma_wide<384>(a);
      case 448: return (int)launch_dkv_wgmma_wide<448>(a);
      case 512: return (int)launch_dkv_wgmma_wide<512>(a);
      default: break;
    }
  if (!dkv && dtype == 0) switch (head_dim) {
      case 64: return (int)launch_dq_tf32<64>(a);
      case 128: return (int)launch_dq_tf32<128>(a);
      case 192: return (int)launch_dq_tf32_wide<192>(a);
      case 256: return (int)launch_dq_tf32_wide<256>(a);
      case 320: return (int)launch_dq_tf32_wide<320>(a);
      case 384: return (int)launch_dq_tf32_wide<384>(a);
      case 448: return (int)launch_dq_tf32_wide<448>(a);
      case 512: return (int)launch_dq_tf32_wide<512>(a);
      default: break;
    }
  if (dkv && dtype == 0) switch (head_dim) {
      case 64: return (int)launch_dkv_tf32<64>(a);
      case 128: return (int)launch_dkv_tf32<128>(a);
      case 192: return (int)launch_dkv_tf32_wide<192>(a);
      case 256: return (int)launch_dkv_tf32_wide<256>(a);
      case 320: return (int)launch_dkv_tf32_wide<320>(a);
      case 384: return (int)launch_dkv_tf32_wide<384>(a);
      case 448: return (int)launch_dkv_tf32_wide<448>(a);
      case 512: return (int)launch_dkv_tf32_wide<512>(a);
      default: break;
    }
  if (head_dim > 512 && head_dim % TILE == 0) {
    if (dkv && dtype == 0) return (int)launch_dkv_wide<float>(a, head_dim);
    if (dkv && dtype == 1) return (int)launch_dkv_wide<bf16>(a, head_dim);
    if (dtype == 0) return (int)launch_dq_wide<float>(a, head_dim);
    if (dtype == 1) return (int)launch_dq_wide<bf16>(a, head_dim);
    return (int)cudaErrorInvalidValue;
  }
  if (!dkv) {
    if (dtype == 1 && head_dim == 64) return (int)launch_dq_wgmma<64>(a);
    if (dtype == 1 && head_dim == 128) return (int)launch_dq_wgmma<128>(a);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1 && head_dim == 64) return (int)launch_dkv_wgmma<64>(a);
  if (dtype == 1 && head_dim == 128) return (int)launch_dkv_wgmma<128>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, do: (bh, sq, d); k, v: (bh, sk, d), all contiguous in one type
// (dtype 0 = float32, 1 = bfloat16); lse, delta: (bh, sq) float32. d is
// 64, 128 or any multiple of 64 above 128, or in bf16 also 8, 16, 24 or 32
// (the narrow kernels); bh any count whose grid fits gridDim.x. dq: (bh,
// sq, d) in the input type. seed_u32, magic, extra, base: the dropout key
// (DropKey in flash_common.cuh). Returns a cudaError_t (0 = launched).
extern "C" int ff_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
    int head_dim, int dtype, int causal, float sm_scale, int use_dropout,
    unsigned int threshold, float keep_prob, unsigned int seed_u32,
    unsigned int magic, unsigned int extra, unsigned int base,
    void* stream) {
  const DropKey seed{seed_u32, magic, extra, base};
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, bh, sq, sk,
               causal, sm_scale, use_dropout, threshold, keep_prob, seed,
               static_cast<cudaStream_t>(stream)};
  return dispatch(false, dtype, head_dim, a);
}

// As above; dk, dv: (bh, sk, d) in the input type.
extern "C" int ff_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
    int sk, int head_dim, int dtype, int causal, float sm_scale,
    int use_dropout, unsigned int threshold, float keep_prob,
    unsigned int seed_u32, unsigned int magic, unsigned int extra,
    unsigned int base, void* stream) {
  const DropKey seed{seed_u32, magic, extra, base};
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, bh, sq, sk, causal,
               sm_scale, use_dropout, threshold, keep_prob, seed,
               static_cast<cudaStream_t>(stream)};
  return dispatch(true, dtype, head_dim, a);
}
