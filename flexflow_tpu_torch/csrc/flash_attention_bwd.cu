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
//   - dk/dv: a CTA owns 64 keys of one b*h and loops over the q tiles
//     (from the causal diagonal on), holding dk and dv in registers.
// No output row is written by two CTAs, so no atomics and no second pass.
// Each warp owns 16 rows of the CTA's tile. The dk/dv kernel works in the
// transposed frame (s^T = K . Q^T, dp^T = V . dO^T), so its P^T and dS^T
// fragments are directly the A operands of dV += P^T . dO and dK += dS^T .
// Q. For bf16 every product runs on the tensor cores (mma.sync m16n8k16,
// f32 accumulate) and the casts of ds and p_eff happen where the fragments
// are packed to bf16; f32 inputs take FMA loops and stay exact f32. Ragged
// sq and kv_len edges are masked inside the kernel: tiles load zero rows
// past the edge, out-of-range (i, j) get p = 0, and their rows are never
// written. Dead causal tiles are skipped by the reference's liveness
// rules. Rows with l == 0 need nothing special: the forward's lse = m then
// gives the same p as the forward's.
//
// Bound. dq does 6*sq*sk*d flops per head (Q.K^T, dO.V^T, dS.K) and dk/dv
// 8*sq*sk*d (Q.K^T, dO.V^T, P^T.dO, dS^T.Q); each reads q, k, v, do once
// plus the f32 lse and delta, and writes its outputs once. At BERT shapes
// (d = 64, s <= 512) both sit near the H100's bf16 ridge: bytes bound at
// s = 128, operations at s = 512. This first version loads tiles
// synchronously (no cp.async/TMA pipeline, no wgmma), so it sits well
// above either bound; both are later work.

#include "flash_common.cuh"

namespace {

using namespace ff_flash;

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

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
}

__device__ __forceinline__ void zero_frags(float (&s)[N_FRAGS][4]) {
#pragma unroll
  for (int nt = 0; nt < N_FRAGS; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
}

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int sq, int sk, float sm_scale, int causal,
                        int use_dropout, uint32_t threshold, float keep_prob,
                        uint32_t seed) {
  constexpr int LD = D + 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + TILE * LD;
  T* sK = sDO + TILE * LD;
  T* sV = sK + TILE * LD;
  float* sP = reinterpret_cast<float*>(sV + TILE * LD);

  const int m0 = blockIdx.x * TILE;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const T* kb = k + (size_t)bh * sk * D;
  const T* vb = v + (size_t)bh * sk * D;

  load_tile<T, D>(sQ, q + (size_t)bh * sq * D, m0, sq);
  load_tile<T, D>(sDO, dout + (size_t)bh * sq * D, m0, sq);
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
    load_tile<T, D>(sK, kb, n0, sk);
    load_tile<T, D>(sV, vb, n0, sk);
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
  store_rows<T, D>(dq + (size_t)bh * sq * D, acc, m0, sq, warp, g, tig);
}

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int sq, int sk, float sm_scale,
                         int causal, int use_dropout, uint32_t threshold,
                         float keep_prob, uint32_t seed) {
  constexpr int LD = D + 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + TILE * LD;
  T* sQ = sV + TILE * LD;
  T* sDO = sQ + TILE * LD;
  float* sLse = reinterpret_cast<float*>(sDO + TILE * LD);
  float* sDelta = sLse + TILE;
  float* sP = sDelta + TILE;

  const int n0 = blockIdx.x * TILE;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const T* qb = q + (size_t)bh * sq * D;
  const T* db = dout + (size_t)bh * sq * D;

  load_tile<T, D>(sK, k + (size_t)bh * sk * D, n0, sk);
  load_tile<T, D>(sV, v + (size_t)bh * sk * D, n0, sk);
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
    load_tile<T, D>(sQ, qb, m0, sq);
    load_tile<T, D>(sDO, db, m0, sq);
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
  store_rows<T, D>(dk + (size_t)bh * sk * D, dk_acc, n0, sk, warp, g, tig);
  store_rows<T, D>(dv + (size_t)bh * sk * D, dv_acc, n0, sk, warp, g, tig);
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

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr int LD = D + 16 / sizeof(T);
  size_t smem = (size_t)4 * TILE * LD * sizeof(T);
  if (sizeof(T) == 4) smem += (size_t)TILE * P_LD * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + TILE - 1) / TILE, a.bh);
  kernel<<<grid, NUM_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), a.sq, a.sk, a.sm_scale, a.causal,
      a.use_dropout, a.threshold, a.keep_prob, a.seed);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr int LD = D + 16 / sizeof(T);
  size_t smem = (size_t)4 * TILE * LD * sizeof(T) + 2 * TILE * sizeof(float);
  if (sizeof(T) == 4) smem += (size_t)TILE * P_LD * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sk + TILE - 1) / TILE, a.bh);
  kernel<<<grid, NUM_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.sq, a.sk,
      a.sm_scale, a.causal, a.use_dropout, a.threshold, a.keep_prob, a.seed);
  return cudaGetLastError();
}

int dispatch(bool dkv, int dtype, int head_dim, const Args& a) {
  if (a.bh <= 0 || a.bh > 65535 || a.sq <= 0 || a.sk <= 0)
    return (int)cudaErrorInvalidValue;
#define FF_BWD(T, D) \
  return (int)(dkv ? launch_dkv<T, D>(a) : launch_dq<T, D>(a))
  if (dtype == 1 && head_dim == 64) FF_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) FF_BWD(__nv_bfloat16, 128);
  if (dtype == 0 && head_dim == 64) FF_BWD(float, 64);
  if (dtype == 0 && head_dim == 128) FF_BWD(float, 128);
#undef FF_BWD
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
