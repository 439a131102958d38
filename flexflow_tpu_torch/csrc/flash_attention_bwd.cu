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
// position_hash(seed, b*h, i, j) >= threshold, the forward's tuple.
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
//   dq and dk/dv, f32 - flash_bwd_dq_kernel and flash_bwd_dkv_kernel, the
//   exact FMA path (64-row tiles, four warps, synchronous tile loads),
//   because the tensor cores would round f32 to TF32.
//
// Bound. dq does 6*sq*sk*d flops per head (Q.K^T, dO.V^T, dS.K) and dk/dv
// 8*sq*sk*d (Q.K^T, dO.V^T, P^T.dO, dS^T.Q); each reads q, k, v, do once
// plus the f32 lse and delta, and writes its outputs once. At BERT shapes
// (d = 64, s <= 512) both sit near the H100's bf16 ridge: bytes bound at
// s = 128 (dq 2.38 us, dk/dv 2.85 us at b8 h12 d64), operations at s = 512
// (dq 9.77 us, dk/dv 13.03 us at 989 TFLOP/s). Inside the kernels the
// exponentials (one MUFU ex2 per score, 16 per SM per clock) and the
// products serialize in part, as in the forward.

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
    uint32_t seed, LseFn lse_of, DeltaFn delta_of) {
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

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int sq, int sk, float sm_scale, int causal,
                        int use_dropout, uint32_t threshold, float keep_prob,
                        uint32_t seed) {
  constexpr int LD = D + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = sQ + TILE * LD;
  float* sK = sDO + TILE * LD;
  float* sV = sK + TILE * LD;
  float* sP = sV + TILE * LD;

  const int m0 = blockIdx.x * TILE;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const float* kb = k + (size_t)bh * sk * D;
  const float* vb = v + (size_t)bh * sk * D;

  load_tile<D>(sQ, q + (size_t)bh * sq * D, m0, sq);
  load_tile<D>(sDO, dout + (size_t)bh * sq * D, m0, sq);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = m0 + warp * 16 + g + 8 * r;
    lse_r[r] = qp < sq ? lse[(size_t)bh * sq + qp] : 0.f;
    delta_r[r] = qp < sq ? delta[(size_t)bh * sq + qp] : 0.f;
  }
  auto lse_of = [&](int r) { return lse_r[r]; };
  auto delta_of = [&](int r) { return delta_r[r]; };

  float acc[D / 8][4];
  zero_acc<D>(acc);
  int n_tiles = (sk + TILE - 1) / TILE;
  if (causal)  // a K tile is live iff its first key is visible to the
               // tile's last query (the reference's rule)
    n_tiles = min(n_tiles, (m0 + TILE - 1) / TILE + 1);

  for (int tn = 0; tn < n_tiles; ++tn) {
    const int n0 = tn * TILE;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb, n0, sk);
    load_tile<D>(sV, vb, n0, sk);
    __syncthreads();
    float s[N_FRAGS][4], dp[N_FRAGS][4];
    zero_frags(s);
    zero_frags(dp);
    scores<D>(s, sQ, sK, warp, g, tig);
    scores<D>(dp, sDO, sV, warp, g, tig);
    tile_grads<false>(s, dp, m0, n0, warp, g, tig, bh, sq, sk, causal,
                      sm_scale, use_dropout, threshold, keep_prob, seed,
                      lse_of, delta_of);
    accumulate_pv<D>(acc, dp, sK, sP, warp, g, tig);  // dq += ds . k
  }
  store_rows<D>(dq + (size_t)bh * sq * D, acc, m0, sq, warp, g, tig);
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int sq, int sk, float sm_scale, int causal,
                         int use_dropout, uint32_t threshold, float keep_prob,
                         uint32_t seed) {
  constexpr int LD = D + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + TILE * LD;
  float* sQ = sV + TILE * LD;
  float* sDO = sQ + TILE * LD;
  float* sLse = sDO + TILE * LD;
  float* sDelta = sLse + TILE;
  float* sP = sDelta + TILE;

  const int n0 = blockIdx.x * TILE;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const float* qb = q + (size_t)bh * sq * D;
  const float* db = dout + (size_t)bh * sq * D;

  load_tile<D>(sK, k + (size_t)bh * sk * D, n0, sk);
  load_tile<D>(sV, v + (size_t)bh * sk * D, n0, sk);
  auto lse_of = [&](int c) { return sLse[c]; };
  auto delta_of = [&](int c) { return sDelta[c]; };

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero_acc<D>(dk_acc);
  zero_acc<D>(dv_acc);
  const int n_tiles = (sq + TILE - 1) / TILE;
  // causal: a q tile is live iff its last query can see the first key
  const int first = causal ? n0 / TILE : 0;

  for (int tm = first; tm < n_tiles; ++tm) {
    const int m0 = tm * TILE;
    __syncthreads();  // every warp is done with the previous q tile
    load_tile<D>(sQ, qb, m0, sq);
    load_tile<D>(sDO, db, m0, sq);
    for (int i = threadIdx.x; i < TILE; i += NUM_THREADS) {
      const int qp = m0 + i;
      sLse[i] = qp < sq ? lse[(size_t)bh * sq + qp] : 0.f;
      sDelta[i] = qp < sq ? delta[(size_t)bh * sq + qp] : 0.f;
    }
    __syncthreads();
    float s[N_FRAGS][4], dp[N_FRAGS][4];
    zero_frags(s);
    zero_frags(dp);
    scores<D>(s, sK, sQ, warp, g, tig);    // s^T = k . q^T
    scores<D>(dp, sV, sDO, warp, g, tig);  // dp^T = v . do^T
    tile_grads<true>(s, dp, n0, m0, warp, g, tig, bh, sq, sk, causal,
                     sm_scale, use_dropout, threshold, keep_prob, seed,
                     lse_of, delta_of);
    accumulate_pv<D>(dv_acc, s, sDO, sP, warp, g, tig);  // dv += p_eff^T.do
    accumulate_pv<D>(dk_acc, dp, sQ, sP, warp, g, tig);  // dk += ds^T . q
  }
  store_rows<D>(dk + (size_t)bh * sk * D, dk_acc, n0, sk, warp, g, tig);
  store_rows<D>(dv + (size_t)bh * sk * D, dv_acc, n0, sk, warp, g, tig);
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
  uint32_t seed;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& a) {
  const size_t smem =
      ((size_t)4 * TILE * (D + 4) + (size_t)TILE * P_LD) * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<D>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + TILE - 1) / TILE, a.bh);
  kernel<<<grid, NUM_THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.out0), a.sq, a.sk, a.sm_scale,
      a.causal, a.use_dropout, a.threshold, a.keep_prob, a.seed);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = ((size_t)4 * TILE * (D + 4) + 2 * TILE +
                       (size_t)TILE * P_LD) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<D>;
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sk + TILE - 1) / TILE, a.bh);
  kernel<<<grid, NUM_THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.out0),
      static_cast<float*>(a.out1), a.sq, a.sk, a.sm_scale, a.causal,
      a.use_dropout, a.threshold, a.keep_prob, a.seed);
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
        float keep_prob, uint32_t seed) {
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
  const int n0 = blockIdx.x * BN;
  const int bh = blockIdx.y;
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
    uint32_t keep = 0;
    if (DROPOUT) {
#pragma unroll
      for (int nt = 0; nt < NB; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          keep |= (uint32_t)(position_hash(seed, bh,
                                           m0 + nt * 8 + tig * 2 + (c & 1),
                                           kpos[c >> 1]) >= threshold)
                  << (4 * nt + c);
    }

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
  const dim3 grid((a.sk + Tl::BN - 1) / Tl::BN, a.bh);
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
                              float keep_prob, uint32_t seed) {
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
  const int m0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
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
  const dim3 grid((a.sq + Tl::BM - 1) / Tl::BM, a.bh);
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

int dispatch(bool dkv, int dtype, int head_dim, const Args& a) {
  if (a.bh <= 0 || a.bh > 65535 || a.sq <= 0 || a.sk <= 0)
    return (int)cudaErrorInvalidValue;
  // bf16 runs the wgmma kernels, f32 the exact FMA kernels
  if (!dkv) {
    if (dtype == 1 && head_dim == 64) return (int)launch_dq_wgmma<64>(a);
    if (dtype == 1 && head_dim == 128) return (int)launch_dq_wgmma<128>(a);
    if (dtype == 0 && head_dim == 64) return (int)launch_dq<64>(a);
    if (dtype == 0 && head_dim == 128) return (int)launch_dq<128>(a);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1 && head_dim == 64) return (int)launch_dkv_wgmma<64>(a);
  if (dtype == 1 && head_dim == 128) return (int)launch_dkv_wgmma<128>(a);
  if (dtype == 0 && head_dim == 64) return (int)launch_dkv<64>(a);
  if (dtype == 0 && head_dim == 128) return (int)launch_dkv<128>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, do: (bh, sq, d); k, v: (bh, sk, d), all contiguous in one type
// (dtype 0 = float32, 1 = bfloat16); lse, delta: (bh, sq) float32. d is
// 64 or 128. dq: (bh, sq, d) in the input type. Returns a cudaError_t
// (0 = launched).
extern "C" int ff_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
    int head_dim, int dtype, int causal, float sm_scale, int use_dropout,
    unsigned int threshold, float keep_prob, unsigned int seed,
    void* stream) {
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
    unsigned int seed, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, bh, sq, sk, causal,
               sm_scale, use_dropout, threshold, keep_prob, seed,
               static_cast<cudaStream_t>(stream)};
  return dispatch(true, dtype, head_dim, a);
}
