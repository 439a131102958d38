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

#include "flash_common.cuh"

namespace {

using namespace ff_flash;

constexpr int BLOCK_M = TILE;  // query rows per CTA
constexpr int BLOCK_N = TILE;  // keys per K/V tile

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
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
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
