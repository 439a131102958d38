// Hopper (sm_90a) building blocks of the three bf16 flash-attention
// kernels (the forward in flash_attention_fwd.cu, dq and dk/dv in
// flash_attention_bwd.cu):
//
//   - two ways to fill a ring of shared-memory stages, so one stage's copy
//     is in flight while the previous stage's products run: cp.async
//     copies of 16 bytes per thread grouped with commit_group / wait_group
//     (rows past an edge zero-filled with src-size 0; any alignment of 4
//     bytes, so also for per-row f32 vectors), or TMA, one thread issuing
//     a 3-d tensor copy per tile that completes on an mbarrier (rows past
//     a head's end arrive as zeros; no thread spends registers or issue
//     slots on addresses), its tensor map encoded on the host per launch;
//   - the 128-byte-swizzled shared-memory layout that wgmma reads: a bf16
//     tile of ROWS x D is D/64 column blocks of ROWS x 128 bytes (a d=64
//     row is one 128-byte swizzle atom, d=128 two), and the 16-byte chunk
//     c of row r sits at r*128 + ((c ^ (r % 8)) * 16). Every block starts
//     on a 1024-byte boundary, the swizzle pattern's period;
//   - the wgmma matrix descriptor of that layout, read K-major (the
//     contiguous 128 bytes run along the product's K dimension) or
//     MN-major (they run along M or N: the transpose bit), so one staged
//     tile serves as either operand without a transpose in shared memory;
//   - wgmma.mma_async m64n64k16 and m64n32k16 (bf16 in, f32 accumulate)
//     with both operands in shared memory, and m64n64k16 with A in
//     registers. The accumulator
//     of a warpgroup's 64 x 64 product is the mma.sync m16n8k16 C layout
//     repeated every 8 columns: warp w owns rows 16w..16w+15, and
//     d[4j + c] is row g + 8 * (c >> 1), column 8j + 2 * tig + (c & 1)
//     with g = lane / 4, tig = lane % 4. The register A operand is the
//     m16n8k16 A layout, so two adjacent 8-column blocks of an
//     accumulator, rounded to bf16, are one 16-deep A slice.
//
// The forward and dq fill their rings by TMA (K/V tiles, with Q, and dO
// for dq, resident); dk/dv by cp.async, since it also streams per-row
// lse and delta vectors.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver function that
                   // encodes one is fetched at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ff_hopper {

constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int WG_ROWS = 64;      // rows of a wgmma product per warpgroup
constexpr int SW_ROW = 128;      // bytes of one swizzled row
constexpr int SW_ATOM = 1024;    // bytes of one 8-row swizzle atom
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// the tile ring: cp.async with commit/wait groups
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's shared-memory writes visible to wgmma (the async
// proxy); a barrier after it publishes them to the other threads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of (row r, 16-byte chunk c) in a swizzled ROWS x D tile.
template <int ROWS>
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return (c >> 3) * (ROWS * SW_ROW) + r * SW_ROW + (((c & 7) ^ (r & 7)) << 4);
}

// Copy rows [row0, row0 + ROWS) of a row-major (n_rows, D) bf16 matrix
// into the swizzled tile at dst, NTHREADS threads 16 bytes each at a time;
// rows past n_rows are zero-filled and read nothing.
template <int ROWS, int D, int NTHREADS>
__device__ __forceinline__ void load_tile_sw128(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int row0, int n_rows,
                                                int tid) {
  constexpr int CHUNKS = D / 8;
  static_assert((ROWS * CHUNKS) % NTHREADS == 0, "uneven tile copy");
#pragma unroll
  for (int j = 0; j < ROWS * CHUNKS / NTHREADS; ++j) {
    const int i = tid + j * NTHREADS;
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = row0 + r < n_rows;
    const __nv_bfloat16* s = src + (size_t)(ok ? row0 + r : 0) * D + c * 8;
    cp_async_16(dst + sw128_offset<ROWS>(r, c), s, ok ? 16u : 0u);
  }
}

// Copy n floats src[row0 .. row0 + n) into dst, zero past n_rows; threads
// with idx in [0, n) each copy one.
__device__ __forceinline__ void load_vec_f32(uint32_t dst, const float* src,
                                             int row0, int n_rows, int n,
                                             int idx) {
  if (idx >= 0 && idx < n) {
    const bool ok = row0 + idx < n_rows;
    cp_async_4(dst + 4 * idx, src + (ok ? row0 + idx : 0), ok ? 4u : 0u);
  }
}

// ---------------------------------------------------------------------------
// the tile ring: TMA copies completing on mbarriers
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// make initialized barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of copies to complete this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of the given parity to complete. A phase that never
// completes (a copy that was never issued) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins == (1u << 26)) __trap();
  }
}

// Copy the box at (c0, c1, c2) of a 3-d tensor map into shared memory at
// dst; the transferred bytes count toward bar's phase.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Copy rows [row0, row0 + ROWS) of head bh of a (bh, rows, D) bf16 tensor
// into the swizzled tile at dst: one TMA box of ROWS x 64 per 64-column
// block. Rows past the head's end arrive as zeros.
template <int ROWS, int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row0,
                                              int bh) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
    tma_load_3d(dst + h * (ROWS * SW_ROW), map, bar, 64 * h, row0, bh);
}

// Store the swizzled tile at src to rows [row0, row0 + ROWS) of head bh
// (rows past the head's end are not written), as one bulk group.
template <int ROWS, int D>
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map,
                                               uint32_t src, int row0,
                                               int bh) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
        " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(src + h * (ROWS * SW_ROW)), "r"(64 * h), "r"(row0), "r"(bh)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until the committed bulk stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The tensor map of a contiguous (bh, rows, d) bf16 tensor as TMA boxes
// of box_rows x 64 in the 128-byte swizzle, zeros past every edge. A host
// call per launch, since the pointer changes; cuTensorMapEncodeTiled is
// looked up once through the runtime.
inline cudaError_t tensor_map_bf16(CUtensorMap* map, const void* ptr, int bh,
                                   int rows, int d, int box_rows) {
  static TensorMapEncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<TensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Matrix descriptor of a 128-byte-swizzled operand starting at addr:
// consecutive 8-row groups SW_ATOM bytes apart (the stride byte offset);
// lbo_bytes is the leading byte offset (for an MN-major operand the
// distance between 64-element column blocks; unused by the m64n64k16
// products here, which never span two blocks).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(SW_ATOM >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across a
// wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for register A fragments, which an RS product reads while it
// runs: their registers stay untouched until after its wait.
template <int N>
__device__ __forceinline__ void fence_regs_u32(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define FF_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FF_D16(i) FF_D4(i), FF_D4(i + 4), FF_D4(i + 8), FF_D4(i + 12)
#define FF_D32 FF_D16(0), FF_D16(16)
#define FF_D32_LIST                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"

// d (64 x 64, f32) = A . B (+ d if accumulate), A (64 x 16) and B (16 x 64)
// bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FF_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FF_D32
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, f32) = A . B (+ d if accumulate), A (64 x 16 bf16) in
// registers as the m16n8k16 A fragment of this thread's warp, B (16 x 64)
// in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FF_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : FF_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(TRANS_B));
}

#define FF_D16_LIST                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// As wgmma_ss_m64n64k16, 32 columns wide.
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " FF_D16_LIST
      ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : FF_D16(0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef FF_D4
#undef FF_D16
#undef FF_D16_LIST
#undef FF_D32
#undef FF_D32_LIST

// The accumulator block of 8-column blocks [8h, 8h + 8) of a (64 x 8n)
// accumulator held as float[n][4], flat: the d operand of one m64n64
// product.
template <int NB>
__device__ __forceinline__ float (&acc_block(float (&acc)[NB][4], int h))[32] {
  return *reinterpret_cast<float(*)[32]>(&acc[8 * h][0]);
}

// s (64 x 8NB, f32) = A . B over one 16-deep slice, both operands K-major
// in shared memory: one m64n32 (NB = 4) or m64n64 (NB = 8) product.
template <int NB>
__device__ __forceinline__ void wgmma_ss_kk(float (&s)[NB][4],
                                            uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  static_assert(NB == 4 || NB == 8, "32 or 64 columns");
  if constexpr (NB == 4)
    wgmma_ss_m64n32k16(*reinterpret_cast<float(*)[16]>(&s[0][0]), desc_a,
                       desc_b, accumulate);
  else
    wgmma_ss_m64n64k16(acc_block(s, 0), desc_a, desc_b, accumulate);
}

template <int NB>
__device__ __forceinline__ void fence_acc(float (&s)[NB][4]) {
  fence_regs(*reinterpret_cast<float(*)[4 * NB]>(&s[0][0]));
}

// Round a 64 x 8NB accumulator (this thread's 4NB values) to bf16 A
// fragments: a[kc] is the 16-deep slice of columns [16kc, 16kc + 16).
template <int NB>
__device__ __forceinline__ void to_a_frags(const float (&s)[NB][4],
                                           uint32_t (&a)[NB / 2][4]) {
#pragma unroll
  for (int kc = 0; kc < NB / 2; ++kc) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(s[2 * kc + j][0],
                                                s[2 * kc + j][1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(s[2 * kc + j][2],
                                                s[2 * kc + j][3]);
      a[kc][2 * j] = *reinterpret_cast<uint32_t*>(&lo);
      a[kc][2 * j + 1] = *reinterpret_cast<uint32_t*>(&hi);
    }
  }
}

// 2^x on the MUFU unit (flushes subnormal results to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace ff_hopper
