// Fused multi-tensor Adam update for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the Pallas TPU kernel flexflow_tpu/kernels/opt_update.py
// ::_adam_kernel (launched once per parameter leaf by fused_adam_update).
// For every element of every leaf, in f32:
//   g  = g + wd * w
//   m' = beta1 * m + (1 - beta1) * g
//   v' = beta2 * v + (1 - beta2) * g * g
//   w' = w - cast_w(alpha_t * m' / (sqrt(v') + eps))
// and writes w' (in w's type, f32 or bf16), m' and v' (f32) in place.
// alpha_t, the bias-corrected step size, is read from a device scalar, so
// the step count never has to reach the host.
//
// Rounding. Every operation is an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn), so nvcc cannot contract
// a multiply and an add into an FMA. The plain PyTorch version in
// kernels/opt_update.py runs the same operations as separate IEEE ops and
// the two agree bit for bit.
//
// Design. The TPU kernel runs once per leaf over the leaf padded to
// (rows, 128). Here one launch covers up to MAX_LEAVES leaves: a device
// table, built once per parameter set, holds each leaf's w/m/v pointers,
// size and type, and maps every block to (leaf, first element). The
// gradients are new tensors every step, so their pointers travel in the
// kernel's parameter space instead (MAX_LEAVES * 8 bytes, within the 4 KB
// limit), which costs no copy. Each block updates CHUNK consecutive
// elements of one leaf, neighbouring threads on neighbouring elements.
//
// Bound. 28 bytes per f32 parameter (w, g, m, v read; w, m, v written)
// against ~15 flops: bytes bound at any size, ~0.9 ms for BERT-base's
// 109 M parameters at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 384;
constexpr int THREADS = 256;
constexpr int CHUNK = THREADS * 16;  // elements per block

struct Leaf {
  void* w;
  float* m;
  float* v;
  long long n;
  int dtype;  // 0 = float32, 1 = bfloat16 (w and g)
  int pad;
};

struct GradPtrs {
  const void* g[MAX_LEAVES];
};

__device__ __forceinline__ float load(const void* p, int dtype, long long i) {
  if (dtype == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(THREADS)
    adam_kernel(const Leaf* __restrict__ leaves,
                const int* __restrict__ block_leaf,
                const long long* __restrict__ block_start, GradPtrs grads,
                const float* __restrict__ alpha_t, float beta1,
                float one_minus_beta1, float beta2, float one_minus_beta2,
                float eps, float wd) {
  const int li = block_leaf[blockIdx.x];
  const Leaf leaf = leaves[li];
  const long long start = block_start[blockIdx.x];
  const long long end =
      start + CHUNK < leaf.n ? start + CHUNK : leaf.n;
  const void* gp = grads.g[li];
  const float a = *alpha_t;
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    const float w = load(leaf.w, leaf.dtype, i);
    const float g = __fadd_rn(load(gp, leaf.dtype, i), __fmul_rn(wd, w));
    const float m = __fadd_rn(__fmul_rn(beta1, leaf.m[i]),
                              __fmul_rn(one_minus_beta1, g));
    const float v = __fadd_rn(__fmul_rn(beta2, leaf.v[i]),
                              __fmul_rn(__fmul_rn(one_minus_beta2, g), g));
    const float step =
        __fdiv_rn(__fmul_rn(a, m), __fadd_rn(__fsqrt_rn(v), eps));
    leaf.m[i] = m;
    leaf.v[i] = v;
    if (leaf.dtype == 1) {
      // the step is cast to w's type before the subtraction, as in the
      // reference (w - step.astype(w.dtype))
      const float st = __bfloat162float(__float2bfloat16_rn(step));
      static_cast<__nv_bfloat16*>(leaf.w)[i] =
          __float2bfloat16_rn(__fsub_rn(w, st));
    } else {
      static_cast<float*>(leaf.w)[i] = __fsub_rn(w, step);
    }
  }
}

}  // namespace

extern "C" int ff_adam_max_leaves() { return MAX_LEAVES; }
extern "C" int ff_adam_chunk() { return CHUNK; }

// leaves: device array of n_leaves Leaf records; block_leaf (int32) and
// block_start (int64): device arrays of n_blocks entries; g_ptrs: host
// array of n_leaves gradient pointers (each leaf's g has w's type and
// size); alpha_t: device float32 scalar. Returns a cudaError_t (0 =
// launched).
extern "C" int ff_adam_update(const void* leaves, const void* block_leaf,
                              const void* block_start, int n_blocks,
                              const unsigned long long* g_ptrs, int n_leaves,
                              const void* alpha_t, float beta1,
                              float one_minus_beta1, float beta2,
                              float one_minus_beta2, float eps, float wd,
                              void* stream) {
  if (n_leaves <= 0 || n_leaves > MAX_LEAVES || n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  GradPtrs grads;
  for (int i = 0; i < MAX_LEAVES; ++i)
    grads.g[i] = i < n_leaves ? reinterpret_cast<const void*>(g_ptrs[i])
                              : nullptr;
  adam_kernel<<<n_blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const int*>(block_leaf),
      static_cast<const long long*>(block_start), grads,
      static_cast<const float*>(alpha_t), beta1, one_minus_beta1, beta2,
      one_minus_beta2, eps, wd);
  return (int)cudaGetLastError();
}
