// Hopper (sm_90a) building blocks of the flash-attention kernels on the
// tensor cores: the bf16 forward in flash_attention_fwd.cu, dq and dk/dv
// in flash_attention_bwd.cu, the f32 forward, and the f32 dq and dk/dv:
//
//   - two ways to fill a ring of shared-memory stages, so one stage's copy
//     is in flight while the previous stage's products run: cp.async
//     copies of 16 bytes per thread grouped with commit_group / wait_group
//     (rows past an edge zero-filled with src-size 0; any alignment of 4
//     bytes, so also for per-row f32 vectors), or TMA, one thread issuing
//     a 3-d tensor copy per tile that completes on an mbarrier (rows past
//     a head's end arrive as zeros; no thread spends registers or issue
//     slots on addresses), its tensor map encoded on the host per launch
//     (tensor_map_bf16, tensor_map_f32);
//   - the 128-byte-swizzled shared-memory layout that wgmma reads: a tile
//     of ROWS x D is column blocks of ROWS x 128 bytes (64 bf16 or 32 f32
//     columns: a bf16 row of d = 64 is one 128-byte swizzle atom, d = 128
//     two, as is an f32 row of d = 64), and the 16-byte chunk c of row r
//     sits at r*128 + ((c ^ (r % 8)) * 16). Every block starts on a
//     1024-byte boundary, the swizzle pattern's period;
//   - the wgmma matrix descriptor of that layout, read K-major (the
//     contiguous 128 bytes run along the product's K dimension) or, for
//     bf16 only, MN-major (they run along M or N: the transpose bit), so
//     one staged bf16 tile serves as either operand without a transpose in
//     shared memory;
//   - the narrow tiles of the d <= 32 forward, dq and dk/dv: rows of 32
//     or 64 bytes (16 or 32 bf16 columns) in the 32- or 64-byte swizzle,
//     whose 16-byte chunk c of row r sits at r * ROW + (c ^ ((r * ROW /
//     128) % (ROW / 16))) * 16 (sw_offset; the 128-byte layout is its ROW
//     = 128 case), filled by TMA or by cp.async (load_tile_narrow), and
//     their descriptors (desc_sw, the mode and the 8-row atom given);
//   - wgmma.mma_async m64n64k16, m64n32k16 and m64n16k16 (bf16 in, f32
//     accumulate) with both operands in shared memory, and the same three
//     widths with A in registers. The accumulator
//     of a warpgroup's 64 x 64 product is the mma.sync m16n8k16 C layout
//     repeated every 8 columns: warp w owns rows 16w..16w+15, and
//     d[4j + c] is row g + 8 * (c >> 1), column 8j + 2 * tig + (c & 1)
//     with g = lane / 4, tig = lane % 4. The register A operand is the
//     m16n8k16 A layout, so two adjacent 8-column blocks of an
//     accumulator, rounded to bf16, are one 16-deep A slice;
//   - the split-precision TF32 products of the f32 kernels ("3xTF32"):
//     x = hi + lo with hi = x with its low 13 mantissa bits cleared and lo
//     = x - hi (exact in f32) cleared the same way (tf32_split), so a . b
//     = a_hi . b_hi + a_hi . b_lo + a_lo . b_hi up to a_lo . b_lo and lo's
//     own truncation, each about 2^-20 of the product. The tiles are split
//     in shared memory (split_tile_tf32) and run through wgmma m64nNk8
//     .tf32 (N = 32, 64 with both operands in shared memory, 64 and 128
//     with A in registers), which reads TF32 operands K-major only. Its
//     register A operand is the m16n8k8 .tf32 A layout: a[0..3] are
//     (row g, column tig), (g + 8, tig), (g, tig + 4), (g + 8, tig + 4)
//     of an 8-deep slice, where the accumulator holds columns 2 * tig and
//     2 * tig + 1, so an accumulator's 8-column block is the A slice of
//     those 8 keys taken in the order (0, 2, 4, 6, 1, 3, 5, 7)
//     (tf32_a_frags); the B operand stores its keys in that order. A
//     product that contracts over a streamed tile's rows reads a
//     transposed hi / lo copy of the tile in that order
//     (split_transpose_v); an operand of owned rows comes as register A
//     fragments split in registers (q_frags_tf32).
//
// The forward and dq fill their rings by TMA (K/V tiles, with Q, and dO
// for dq, resident); dk/dv by cp.async, since it also streams per-row
// lse and delta vectors (at every head dim, the narrow one included).
// The wide bf16 forward, dq and dk/dv (d 192 ... 512) run two warpgroups
// per CTA; above d = 320 they split D between them (WideSplit) and sum
// their partial score tiles through shared memory (exchange_store /
// exchange_add). The f32 dq and dk/dv stream every operand by TMA in
// 32-column chunks; the wide ones split D at every head dim, those at d =
// 64 and 128 give each warpgroup 64 rows and all of D.

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

// Byte offset of (row r, 16-byte chunk c) in a tile of ROW-byte rows
// (32, 64 or 128) in the ROW-byte swizzle: chunk bits [4, 4 + log2(ROW /
// 16)) of the offset XORed with the bits from 7 up, as TMA and wgmma
// apply it (the tile starts on a 1024-byte boundary).
template <int ROW>
__device__ __forceinline__ uint32_t sw_offset(int r, int c) {
  static_assert(ROW == 32 || ROW == 64 || ROW == 128, "a swizzle span");
  const uint32_t o = r * ROW + c * 16;
  return o ^ (((o >> 7) & (ROW / 16 - 1)) << 4);
}

// Byte offset of (row r, 16-byte chunk c) in a swizzled ROWS x D tile.
template <int ROWS>
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return (c >> 3) * (ROWS * SW_ROW) + r * SW_ROW + (((c & 7) ^ (r & 7)) << 4);
}

// Copy rows [row0, row0 + ROWS) of a row-major (n_rows, D) bf16 matrix
// into the swizzled tile at dst, NTHREADS threads 16 bytes each at a time
// (the last round partial where NTHREADS does not divide the tile's
// chunks); rows past n_rows are zero-filled and read nothing.
template <int ROWS, int D, int NTHREADS>
__device__ __forceinline__ void load_tile_sw128(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int row0, int n_rows,
                                                int tid) {
  constexpr int CHUNKS = D / 8;
  constexpr int TOTAL = ROWS * CHUNKS;
#pragma unroll
  for (int j = 0; j < (TOTAL + NTHREADS - 1) / NTHREADS; ++j) {
    const int i = tid + j * NTHREADS;
    if (TOTAL % NTHREADS != 0 && i >= TOTAL) break;
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = row0 + r < n_rows;
    const __nv_bfloat16* s = src + (size_t)(ok ? row0 + r : 0) * D + c * 8;
    cp_async_16(dst + sw128_offset<ROWS>(r, c), s, ok ? 16u : 0u);
  }
}

// Copy rows [row0, row0 + ROWS) of a row-major (n_rows, d) bf16 matrix (d
// a multiple of 8, at most DP) into a ROWS x DP tile of 2 * DP-byte rows
// in the 2 * DP-byte swizzle (sw_offset), NTHREADS threads 16 bytes each
// at a time; rows past n_rows and columns past d are zero-filled and read
// nothing (the narrow dk/dv kernel's Q and dO tiles).
template <int ROWS, int DP, int NTHREADS>
__device__ __forceinline__ void load_tile_narrow(uint32_t dst,
                                                 const __nv_bfloat16* src,
                                                 int row0, int n_rows, int d,
                                                 int tid) {
  constexpr int CHUNKS = DP / 8;
  constexpr int TOTAL = ROWS * CHUNKS;
  static_assert(TOTAL % NTHREADS == 0, "whole rounds");
#pragma unroll
  for (int j = 0; j < TOTAL / NTHREADS; ++j) {
    const int i = tid + j * NTHREADS;
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = row0 + r < n_rows && c * 8 < d;
    const __nv_bfloat16* s = ok ? src + (size_t)(row0 + r) * d + c * 8 : src;
    cp_async_16(dst + sw_offset<2 * DP>(r, c), s, ok ? 16u : 0u);
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

// Copy rows [row0, row0 + ROWS) of head bh of a (bh, rows, D) tensor
// into the swizzled tile at dst: one TMA box of ROWS x BOX per 128-byte
// column block (BOX = 64 bf16 or 32 f32 columns). Rows past the head's end
// arrive as zeros.
template <int ROWS, int D, int BOX = 64>
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row0,
                                              int bh) {
#pragma unroll
  for (int h = 0; h < D / BOX; ++h)
    tma_load_3d(dst + h * (ROWS * SW_ROW), map, bar, BOX * h, row0, bh);
}

// Store the swizzled tile at src to rows [row0, row0 + ROWS) of head bh
// (rows past the head's end are not written), as one bulk group.
template <int ROWS, int D, int BOX = 64>
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map,
                                               uint32_t src, int row0,
                                               int bh) {
#pragma unroll
  for (int h = 0; h < D / BOX; ++h)
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
        " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(src + h * (ROWS * SW_ROW)), "r"(BOX * h), "r"(row0), "r"(bh)
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

// The tensor map of a contiguous (bh, rows, d) tensor of elem_bytes-byte
// elements as TMA boxes of box_rows x box_cols, zeros past every edge, the
// columns past d too (a load fills them, a store clips them). A host call
// per launch, since the pointer changes; cuTensorMapEncodeTiled is looked
// up once through the runtime.
inline cudaError_t tensor_map_3d(CUtensorMap* map, const void* ptr,
                                 CUtensorMapDataType type, int elem_bytes,
                                 int bh, int rows, int d, int box_rows,
                                 int box_cols, CUtensorMapSwizzle swizzle) {
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
  const cuuint64_t strides[2] = {(cuuint64_t)d * elem_bytes,
                                 (cuuint64_t)rows * d * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows,
                              1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, type, 3, const_cast<void*>(ptr), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// bf16: by default boxes of 64 columns in the 128-byte swizzle (the
// narrow forward: 16 or 32 in the 32- or 64-byte one)
inline cudaError_t tensor_map_bf16(
    CUtensorMap* map, const void* ptr, int bh, int rows, int d, int box_rows,
    int box_cols = 64,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  return tensor_map_3d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, bh,
                       rows, d, box_rows, box_cols, swizzle);
}

// f32: boxes of 32 columns (128 bytes) in the 128-byte swizzle
inline cudaError_t tensor_map_f32(CUtensorMap* map, const void* ptr, int bh,
                                  int rows, int d, int box_rows) {
  return tensor_map_3d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, bh,
                       rows, d, box_rows, 32, CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Matrix descriptor of a 128-byte-swizzled operand starting at addr:
// consecutive 8-row groups SW_ATOM bytes apart (the stride byte offset);
// lbo_bytes is the leading byte offset (for an MN-major operand the
// distance between 64-element column blocks; unused by the m64n64k16
// products here, which never span two blocks).
// The general form: mode 1 is the 128-byte swizzle, 2 the 64-byte and 3
// the 32-byte one; sbo_bytes the distance between 8-row groups (8 rows
// of the swizzle span).
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, uint32_t lbo_bytes,
                                            uint32_t sbo_bytes,
                                            uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) |
         ((uint64_t)mode << 62);
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo_bytes) {
  return desc_sw(addr, lbo_bytes, SW_ATOM, 1);
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

// As wgmma_rs_m64n64k16, 32 and 16 columns wide (the narrow forward's
// O += P . V).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " FF_D16_LIST
      ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : FF_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n16k16(float (&d)[8],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "%14;\n"
      "}\n"
      : FF_D4(0), FF_D4(4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(TRANS_B));
}

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

// As wgmma_ss_m64n64k16, 16 columns wide.
__device__ __forceinline__ void wgmma_ss_m64n16k16(float (&d)[8],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : FF_D4(0), FF_D4(4)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// TF32 wgmma (the f32 forward's split-precision products)
// ---------------------------------------------------------------------------
// .tf32 operands are read K-major only (no transpose bit), 8 deep (32
// bytes, as a 16-deep bf16 slice), so the K-major descriptors of the
// 128-byte layout serve unchanged: one m64nNk8 step reads 32 bytes of
// every row.

// d (64 x 64, f32) = A . B (+ d if accumulate), A (64 x 8) and B (8 x 64)
// TF32 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64k8_tf32(float (&d)[32],
                                                       uint64_t desc_a,
                                                       uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " FF_D32_LIST
      ", %32, %33, p, 1, 1;\n"
      "}\n"
      : FF_D32
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// As wgmma_ss_m64n64k8_tf32, 32 columns wide.
__device__ __forceinline__ void wgmma_ss_m64n32k8_tf32(float (&d)[16],
                                                       uint64_t desc_a,
                                                       uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " FF_D16_LIST
      ", %16, %17, p, 1, 1;\n"
      "}\n"
      : FF_D16(0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, f32) = A . B (+ d if accumulate), A (64 x 8 TF32) in registers as the m16n8k8
// .tf32 A fragment of this thread's warp, B (8 x 64) K-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs_m64n64k8_tf32(float (&d)[32],
                                                       const uint32_t (&a)[4],
                                                       uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " FF_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : FF_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// As wgmma_rs_m64n64k8_tf32, 32 columns wide.
__device__ __forceinline__ void wgmma_rs_m64n32k8_tf32(float (&d)[16],
                                                       const uint32_t (&a)[4],
                                                       uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " FF_D16_LIST
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : FF_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

#define FF_D64 FF_D32, FF_D16(32), FF_D16(48)
#define FF_D64_LIST                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"

// As wgmma_rs_m64n64k8_tf32, 128 columns wide.
__device__ __forceinline__ void wgmma_rs_m64n128k8_tf32(
    float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " FF_D64_LIST
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : FF_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

#undef FF_D64
#undef FF_D64_LIST

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
// in shared memory: one m64n16 (NB = 2), m64n32 (NB = 4) or m64n64 (NB =
// 8) product.
template <int NB>
__device__ __forceinline__ void wgmma_ss_kk(float (&s)[NB][4],
                                            uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  static_assert(NB == 2 || NB == 4 || NB == 8, "16, 32 or 64 columns");
  if constexpr (NB == 2)
    wgmma_ss_m64n16k16(*reinterpret_cast<float(*)[8]>(&s[0][0]), desc_a,
                       desc_b, accumulate);
  else if constexpr (NB == 4)
    wgmma_ss_m64n32k16(*reinterpret_cast<float(*)[16]>(&s[0][0]), desc_a,
                       desc_b, accumulate);
  else
    wgmma_ss_m64n64k16(acc_block(s, 0), desc_a, desc_b, accumulate);
}

// d (64 x 8NB, f32) += A . B over one 16-deep slice, A in registers: one
// m64n16 (NB = 2) or m64n32 (NB = 4) product (the narrow forward's P.V).
template <int NB, int TRANS_B>
__device__ __forceinline__ void wgmma_rs_kk(float (&d)[NB][4],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
  static_assert(NB == 2 || NB == 4, "16 or 32 columns");
  if constexpr (NB == 2)
    wgmma_rs_m64n16k16<TRANS_B>(*reinterpret_cast<float(*)[8]>(&d[0][0]), a,
                                desc_b, accumulate);
  else
    wgmma_rs_m64n32k16<TRANS_B>(*reinterpret_cast<float(*)[16]>(&d[0][0]),
                                a, desc_b, accumulate);
}

// s (64 x 8NB, f32) = A . B (+ s if accumulate) over one 8-deep TF32
// slice, both operands K-major in shared memory: one m64n32 (NB = 4) or
// m64n64 (NB = 8) product.
template <int NB>
__device__ __forceinline__ void wgmma_ss_kk_tf32(float (&s)[NB][4],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  static_assert(NB == 4 || NB == 8, "32 or 64 columns");
  if constexpr (NB == 4)
    wgmma_ss_m64n32k8_tf32(*reinterpret_cast<float(*)[16]>(&s[0][0]),
                           desc_a, desc_b, accumulate);
  else
    wgmma_ss_m64n64k8_tf32(acc_block(s, 0), desc_a, desc_b, accumulate);
}

// d (64 x 8NB, f32) = A . B (+ d if accumulate) over one 8-deep TF32
// slice, A in registers: one m64n32 (NB = 4), m64n64 (NB = 8) or m64n128
// (NB = 16) product (the f32 forwards' P.V, and the wide one's S).
template <int NB>
__device__ __forceinline__ void wgmma_rs_kk_tf32(float (&d)[NB][4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b,
                                                 int accumulate = 1) {
  static_assert(NB == 4 || NB == 8 || NB == 16, "32, 64 or 128 columns");
  if constexpr (NB == 4)
    wgmma_rs_m64n32k8_tf32(*reinterpret_cast<float(*)[16]>(&d[0][0]), a,
                           desc_b, accumulate);
  else if constexpr (NB == 8)
    wgmma_rs_m64n64k8_tf32(acc_block(d, 0), a, desc_b, accumulate);
  else
    wgmma_rs_m64n128k8_tf32(*reinterpret_cast<float(*)[64]>(&d[0][0]), a,
                            desc_b, accumulate);
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

// x with its low 13 mantissa bits cleared: a TF32 value, exactly what the
// tensor cores read of x
__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// x = hi + lo up to lo's own truncation: hi = tf32_trunc(x), lo =
// tf32_trunc(x - hi), the subtraction exact in f32
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = tf32_trunc(x);
  lo = tf32_trunc(x - hi);
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_f4(uint32_t addr, float a, float b,
                                             float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// Split the f32 tile of BYTES at src in place into its hi part and write
// its lo part at the same offsets from lo (any layout: the split is
// elementwise), NTHREADS threads 16 bytes each per round, consecutive
// threads on consecutive chunks.
template <int BYTES, int NTHREADS>
__device__ __forceinline__ void split_tile_tf32(uint32_t src, uint32_t lo,
                                                int tid) {
  static_assert(BYTES % (16 * NTHREADS) == 0, "whole rounds");
#pragma unroll
  for (int j = 0; j < BYTES / (16 * NTHREADS); ++j) {
    const uint32_t off = (tid + j * NTHREADS) * 16;
    const float4 x = ld_shared_f4(src + off);
    float h[4], l[4];
    tf32_split(x.x, h[0], l[0]);
    tf32_split(x.y, h[1], l[1]);
    tf32_split(x.z, h[2], l[2]);
    tf32_split(x.w, h[3], l[3]);
    st_shared_f4(src + off, h[0], h[1], h[2], h[3]);
    st_shared_f4(lo + off, l[0], l[1], l[2], l[3]);
  }
}

// The 64 x 8NB accumulator s (this thread's fragment, p of 8NB keys) as
// TF32 A fragments, hi and lo: slice kc holds the keys of 8-column block
// kc in the order (0, 2, 4, 6, 1, 3, 5, 7), so a[kc] = {s[kc][0],
// s[kc][2], s[kc][1], s[kc][3]} (rows g, g + 8 of keys 2 tig, then of 2
// tig + 1).
template <int NB>
__device__ __forceinline__ void tf32_a_frags(const float (&s)[NB][4],
                                             uint32_t (&hi)[NB][4],
                                             uint32_t (&lo)[NB][4]) {
#pragma unroll
  for (int kc = 0; kc < NB; ++kc) {
    const float x[4] = {s[kc][0], s[kc][2], s[kc][1], s[kc][3]};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float h, l;
      tf32_split(x[j], h, l);
      hi[kc][j] = __float_as_uint(h);
      lo[kc][j] = __float_as_uint(l);
    }
  }
}

// The transposed TF32 B operand of a product that contracts over a
// streamed tile's rows (the f32 forward's P . V, the f32 dq's dS . K,
// dk/dv's P^T . dO and dS^T . Q): hi and lo of a BN x D f32 tile at sv
// (BN rows, keys or queries, 128-byte swizzled as TMA lands it) into the
// D x BN tiles vt_hi and vt_lo (rows the D columns, the BN rows
// contiguous in the order (0, 2, 4, 6, 1, 3, 5, 7) within each 8-row
// group, 128-byte swizzled), by one warpgroup. Each item is a 4 x 4
// block, rows k0 + 2i (k0 = 8a + par) by columns 4c .. 4c + 3, read as
// four 16-byte rows and written as four 16-byte chunks of V^T (rows 8a +
// 2i + par land at positions 8a + 4 par + i). Items map to lanes so that
// each 8-lane phase of a 16-byte access covers eight distinct bank groups
// in the reads (chunk c ^ row) and the writes (position chunk ^ column
// row). A 32 x 32 tile has 64 items: half the warpgroup takes them.
template <int D, int BN>
__device__ __forceinline__ void split_transpose_v(uint32_t sv, uint32_t vt_hi,
                                                  uint32_t vt_lo, int wtid) {
  constexpr int ITEMS = BN * D / 16;
  constexpr int ROUNDS = (ITEMS + WG_THREADS - 1) / WG_THREADS;
  constexpr bool PARTIAL = ITEMS % WG_THREADS != 0;
  static_assert(!PARTIAL || ROUNDS == 1, "whole rounds, or one partial");
  float x[ROUNDS][4][4];
#pragma unroll
  for (int j = 0; j < ROUNDS; ++j) {
    const int it = wtid + j * WG_THREADS;
    if (PARTIAL && it >= ITEMS) continue;
    const int par = it & 1, a = (it >> 1) & 3, b = (it >> 3) & 1,
              e = (it >> 4) & 3, rest = it >> 6;
    const int c = (rest % (D / 32)) * 8 + (((a ^ e) << 1) | b);
    const int k0 = (rest / (D / 32)) * 32 + 8 * a + par;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = ld_shared_f4(sv + sw128_offset<BN>(k0 + 2 * i, c));
      x[j][i][0] = v.x;
      x[j][i][1] = v.y;
      x[j][i][2] = v.z;
      x[j][i][3] = v.w;
    }
  }
#pragma unroll
  for (int j = 0; j < ROUNDS; ++j) {
    const int it = wtid + j * WG_THREADS;
    if (PARTIAL && it >= ITEMS) continue;
    const int par = it & 1, a = (it >> 1) & 3, b = (it >> 3) & 1,
              e = (it >> 4) & 3, rest = it >> 6;
    const int c = (rest % (D / 32)) * 8 + (((a ^ e) << 1) | b);
    const int pos = (rest / (D / 32)) * 8 + 2 * a + par;  // V^T's chunk
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float h[4], l[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) tf32_split(x[j][r][i], h[r], l[r]);
      const uint32_t off = sw128_offset<D>(4 * c + i, pos);
      st_shared_f4(vt_hi + off, h[0], h[1], h[2], h[3]);
      st_shared_f4(vt_lo + off, l[0], l[1], l[2], l[3]);
    }
  }
}

// This thread's TF32 A fragments, hi and lo, of a warpgroup's 64 x 32
// f32 chunk at sq (128-byte swizzled as TMA lands it; the f32 wide
// forward's Q, the f32 dq's Q and dO, dk/dv's K and V): slice kk
// holds columns 8kk + tig and 8kk + tig + 4 of rows g and g + 8 of this
// warp's 16, in the order (g, tig), (g + 8, tig), (g, tig + 4), (g + 8,
// tig + 4). Each 8-lane phase of a load reads eight distinct 16-byte
// chunks.
__device__ __forceinline__ void q_frags_tf32(uint32_t sq, int warp, int g,
                                             int tig, uint32_t (&hi)[4][4],
                                             uint32_t (&lo)[4][4]) {
  const int row = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = ld_shared_f32(
          sq + sw128_offset<WG_ROWS>(row + 8 * (j & 1), 2 * kk + (j >> 1)) +
          tig * 4);
      float h, l;
      tf32_split(x, h, l);
      hi[kk][j] = __float_as_uint(h);
      lo[kk][j] = __float_as_uint(l);
    }
  }
}

// Wait at named barrier `id` (1 ... 15; 0 is __syncthreads) for the
// `count` threads that use it (a warpgroup's 128).
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// the wide kernels (bf16, head dims 192 ... 512): two warpgroups per CTA
// ---------------------------------------------------------------------------
// Dynamic shared memory a CTA may take on an H100 (227 KB), less room for
// the kernels' static mbarriers.
constexpr size_t SMEM_LIMIT = 232448 - 64;

// How the two warpgroups of a wide kernel's CTA share its block of rows
// (query rows; keys in dk/dv) and the D columns (a multiple of 64) of its
// output, and the shared memory that takes; the forward, dq and dk/dv
// decide both here:
//   - D <= 320 (ROW_SPLIT): each warpgroup owns 64 of the CTA's 128 rows
//     and all D columns (a 64 x D f32 accumulator, D / 2 registers a
//     thread), so each K/V tile serves 128 rows;
//   - D > 320, where that accumulator would pass the 255-register limit:
//     the two share one block of 64 rows and split D. Each contracts half
//     of D's 16-deep steps of every score product (steps [kstep0(wg),
//     kstep0(wg) + KSTEPS)) into a partial tile, the two sum their
//     partials through shared memory (exchange_store / exchange_add), and
//     each owns whole 64-column blocks of the output, the first warpgroup
//     the odd one at D / 64 odd: blocks [first_block(wg), first_block(wg)
//     + blocks(wg)).
template <int D>
struct WideSplit {
  static constexpr int NWG = 2;
  static constexpr int THREADS = NWG * WG_THREADS;
  static constexpr bool ROW_SPLIT = D <= 320;
  static constexpr int BM = ROW_SPLIT ? NWG * WG_ROWS : WG_ROWS;  // rows
  static constexpr int BLOCKS = D / 64;
  // a warpgroup's 16-deep steps of a score product, and the most 64-column
  // blocks of the output it owns
  static constexpr int KSTEPS = ROW_SPLIT ? D / 16 : D / 16 / NWG;
  static constexpr int MAX_BLOCKS = ROW_SPLIT ? BLOCKS : (BLOCKS + 1) / 2;
  static_assert(D % 64 == 0 && BLOCKS >= 2, "a multiple of 64 above 64");
  __device__ static int row0(int wg) { return ROW_SPLIT ? wg * WG_ROWS : 0; }
  __device__ static int kstep0(int wg) { return ROW_SPLIT ? 0 : wg * KSTEPS; }
  __device__ static int first_block(int wg) {
    return ROW_SPLIT ? 0 : wg * MAX_BLOCKS;
  }
  __device__ static int blocks(int wg) {
    return ROW_SPLIT || wg == 0 ? MAX_BLOCKS : BLOCKS - MAX_BLOCKS;
  }
  // Dynamic shared memory at streamed tiles of bn rows: `resident` BM x D
  // bf16 tiles (Q; Q and dO; K and V), rings of two stages for the two
  // streamed tensors (K and V; Q and dO), and, when the two split D, two
  // exchange buffers of both warpgroups' partial score tiles (the
  // forward's by tile parity; dq's and dk/dv's for S and for dP).
  static constexpr size_t smem(int resident, int bn) {
    return SW_ATOM + resident * (size_t)BM * D * 2 + 4 * (size_t)bn * D * 2 +
           (ROW_SPLIT ? 0 : 2 * NWG * (size_t)WG_ROWS * bn * 4);
  }
};

// Add the other warpgroup's partial score tile to this one's. Each thread
// stores its fragment in its own slots of buf (one float4 per 8-column
// block, consecutive threads on consecutive 16 bytes, so no bank
// conflicts); after a CTA barrier (exchange_add) it adds the other
// warpgroup's values from the same slots. a + b rounds as b + a, so both
// warpgroups then hold the same sums and run the same softmax.
template <int NB>
__device__ __forceinline__ void exchange_store(float4* buf, int wg, int wtid,
                                               const float (&s)[NB][4]) {
#pragma unroll
  for (int nt = 0; nt < NB; ++nt)
    buf[(wg * NB + nt) * WG_THREADS + wtid] =
        make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
}

template <int NB>
__device__ __forceinline__ void exchange_add(const float4* buf, int wg,
                                             int wtid, float (&s)[NB][4]) {
#pragma unroll
  for (int nt = 0; nt < NB; ++nt) {
    const float4 o = buf[((1 - wg) * NB + nt) * WG_THREADS + wtid];
    s[nt][0] += o.x;
    s[nt][1] += o.y;
    s[nt][2] += o.z;
    s[nt][3] += o.w;
  }
}

}  // namespace ff_hopper
