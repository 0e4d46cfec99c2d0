// Hopper building blocks shared by the tensor-core kernels (the
// flash-attention kernels flash_attention_sm90.cu, bf16, and
// flash_attention_tf32x3.cu and flash_attention_tf32x3_d256.cu, f32; the
// bf16 GEMM matmul_sm90.cu) and the f32 CUDA-core GEMM matmul_f32_sm90.cu
// (its mbarriers, TMA loads and tensor maps): shared memory addresses and wgmma
// descriptors, mbarriers, TMA loads and their tensor maps, wgmma fences
// and waits, register moves between warpgroups, the quad reductions of the
// accumulator fragment's rows, and what the flash kernels share of flash
// attention: the visited kv tiles, the masked online softmax on the S
// fragment, and the launchers' checks and tensor maps. Everything here has
// internal linkage: each source that includes it gets its own copy, and
// the library exports none of it.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kSmemLimit = 232448;  // H100: a block's opt-in maximum

// Error codes of the launchers beyond cudaError_t's: a tensor map the
// driver refused (kMapError + CUresult), or no cuTensorMapEncodeTiled.
constexpr int kMapError = 100000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor of a K-major tile of 8-row groups of
// kRowBytes-byte rows (128, 64 or 32), swizzled across the row.
template <int kRowBytes>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  static_assert(kRowBytes == 128 || kRowBytes == 64 || kRowBytes == 32,
                "swizzle width");
  constexpr uint64_t layout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  constexpr uint64_t sbo = 8 * kRowBytes;  // one 8-row group to the next
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// TMA: the box at (c0, c1) of a 2-D tensor map into shared memory,
// completing its bytes on the mbarrier.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// TMA: the box at (c0, c1, c2) of a 3-D tensor map into shared memory,
// completing `bytes` on the mbarrier.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// A warpgroup's registers a thread: a producer gives some up, consumers
// take them (all four warps of the warpgroup execute it).
template <int N>
__device__ __forceinline__ void set_max_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void set_max_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// Keep the compiler from touching registers that a wgmma still reads or
// writes until the wait before this fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The kv tiles of KT rows that the q tile [q0, q0 + qt) visits: *begin and
// the count. A kv tile is skipped when its logical kv block(s) of bk rows
// lie wholly after the logical q block(s) of bq rows around the q tile
// (causal) or wholly before their window, as the TPU kernel's pl.when
// skips a kv block.
template <int KT>
__device__ __forceinline__ int visited_kv_tiles(int q0, int qt, int seq,
                                                int bq, int bk, int causal,
                                                int window, int* begin) {
  const int n_tiles = (seq + KT - 1) / KT;
  const int64_t q_last = min(q0 + qt, seq) - 1;
  const int64_t lq_lo = (q0 / bq) * static_cast<int64_t>(bq);
  const int64_t lq_hi = (q_last / bq + 1) * static_cast<int64_t>(bq) - 1;
  int kt_end = n_tiles;
  if (causal) {  // tiles starting before the end of lq_hi's kv block
    const int64_t end = (lq_hi / bk + 1) * static_cast<int64_t>(bk);
    const int64_t tiles = (end + KT - 1) / KT;
    if (tiles < n_tiles) kt_end = static_cast<int>(tiles);
  }
  int kt_begin = 0;
  const int64_t w_lo = lq_lo - window + 1;  // oldest key a logical row sees
  if (window > 0 && w_lo > 0)  // tiles ending in or after w_lo's kv block
    kt_begin = static_cast<int>((w_lo / bk) * bk / KT);
  *begin = kt_begin;
  return max(kt_end - kt_begin, 0);
}

// Whether any key of the kv tile [k0, k0 + KT) is visible to a
// warpgroup's rows [r_lo, r_lo + 64).
template <int KT>
__device__ __forceinline__ bool tile_visible(int k0, int r_lo, int kv_len,
                                             int causal, int window) {
  return !(k0 >= kv_len || (causal && k0 > r_lo + 63) ||
           (window > 0 && r_lo - (k0 + KT - 1) >= window));
}

// One kv tile's step of the online softmax on a warpgroup's S accumulator
// fragment (wgmma m64nKT, f32: element 4j + e is row row_a + 8 (e / 2),
// column k0 + 8 j + col_l + e % 2, of the warpgroup's rows from r_lo):
// masked entries go to -inf where the tile crosses a mask edge; the
// running maxima m (log2 units) and this thread's share of the running
// sums l of rows row_a and row_a + 8 are updated; s becomes the
// unnormalized probabilities. Returns the factors (alpha_a, alpha_b) that
// rescale what the rows accumulated before this tile.
template <int KT>
__device__ __forceinline__ float2 online_softmax(
    float (&s)[KT / 2], float& m_a, float& m_b, float& l_a, float& l_b,
    int row_a, int col_l, int r_lo, int k0, int kv_len, int causal,
    int window, float scale_log2) {
  const bool edge = k0 + KT > kv_len || (causal && k0 + KT - 1 > r_lo) ||
                    (window > 0 && r_lo + 63 - k0 >= window);
  if (edge) {
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_a + 8 * (e / 2);
        const int col = k0 + 8 * j + col_l + e % 2;
        const bool ok = col < kv_len && (!causal || row >= col) &&
                        (window <= 0 || row - col < window);
        if (!ok) s[4 * j + e] = -INFINITY;
      }
  }
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float mn_a = fmaxf(m_a, quad_max(mx_a) * scale_log2);
  const float mn_b = fmaxf(m_b, quad_max(mx_b) * scale_log2);
  const float mu_a = mn_a == -INFINITY ? 0.0f : mn_a;  // all masked so far
  const float mu_b = mn_b == -INFINITY ? 0.0f : mn_b;
  const float2 alpha = make_float2(exp2f(m_a - mu_a), exp2f(m_b - mu_b));
  m_a = mn_a;
  m_b = mn_b;
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    s[4 * j] = exp2f(fmaf(s[4 * j], scale_log2, -mu_a));
    s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], scale_log2, -mu_a));
    s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], scale_log2, -mu_b));
    s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], scale_log2, -mu_b));
    sum_a += s[4 * j] + s[4 * j + 1];
    sum_b += s[4 * j + 2] + s[4 * j + 3];
  }
  l_a = l_a * alpha.x + sum_a;  // this thread's share; reduced at the end
  l_b = l_b * alpha.y + sum_b;
  return alpha;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so
// that the library need not link libcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (bh, seq, d) tensor of `elem`-byte elements as a 3-D map with a
// (w, rows, 1) box: the columns [c0, c0 + w) of `rows` rows of one head,
// swizzled across the box's w * elem bytes (128, 64 or 32). Rows past seq
// read as zeros.
inline CUresult make_map(CUtensorMap* map, const void* ptr,
                         CUtensorMapDataType type, int elem, int d, int seq,
                         int bh, int w, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * elem,
                                 static_cast<cuuint64_t>(seq) * d * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(w),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t strides_elem[3] = {1, 1, 1};
  const int bytes = w * elem;
  const CUtensorMapSwizzle swizzle =
      bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_tiled()(map, type, 3, const_cast<void*>(ptr), dims, strides,
                        box, strides_elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A row-major (rows, cols) matrix of `elem`-byte elements whose rows are ld
// elements apart (ld * elem a multiple of 16), as a 2-D tensor map with a
// (box_cols, box_rows) box, swizzled as asked; reads past rows or cols are
// zeros.
inline CUresult make_map_2d(CUtensorMap* map, const void* ptr,
                            CUtensorMapDataType type, int elem, int64_t cols,
                            int64_t rows, int64_t ld, int box_cols,
                            int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t strides_elem[2] = {1, 1};
  return encode_tiled()(map, type, 2, const_cast<void*>(ptr), dims, strides,
                        box, strides_elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The TMA swizzle across rows of `bytes` bytes (128, 64 or 32).
inline CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                    : CU_TENSOR_MAP_SWIZZLE_32B;
}

// Tensor maps of a flash kernel's q, k, v: [0] the full column chunks,
// [1] the tail chunk.
struct FlashMaps {
  CUtensorMap q[2], k[2], v[2];
};

// The checks every flash launcher makes before its launch: 0, or the error
// to return (cudaErrorInvalidValue for an argument out of range,
// cudaErrorMisalignedAddress for an operand not 16-byte aligned, an error
// of making `device` current, kMapError - 1 without cuTensorMapEncodeTiled).
inline int flash_launch_check(const void* q, const void* k, const void* v,
                              const void* o, int64_t batch, int64_t heads,
                              int64_t kv_heads, int64_t seq, int64_t kv_len,
                              int64_t bq, int64_t bk, int device) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (kv_heads <= 0 || heads % kv_heads != 0 || bq <= 0 || bk <= 0 ||
      kv_len < 0 || kv_len > seq || batch > 65535 || heads > 65535 ||
      seq > (1 << 30) || bq > (1 << 30) || bk > (1 << 30) ||
      batch * heads > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(o))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return encode_tiled() == nullptr ? kMapError - 1 : 0;
}

// The tensor maps of (batch * heads, seq, d) q and (batch * kv_heads, seq,
// d) k, v of `elem`-byte elements: boxes of `chunk` columns (one 128-byte
// swizzle row) and then the d % chunk tail, of qt rows for q and kt for k
// and v. 0, or kMapError + the CUresult of a map the driver refused.
inline int make_flash_maps(FlashMaps* maps, const void* q, const void* k,
                           const void* v, CUtensorMapDataType type, int elem,
                           int d, int chunk, int qt, int kt, int seq, int bhq,
                           int bhk) {
  memset(maps, 0, sizeof(*maps));
  const void* ptrs[3] = {q, k, v};
  CUtensorMap* dst[3] = {maps->q, maps->k, maps->v};
  for (int t = 0; t < 3; ++t) {
    const int rows = t == 0 ? qt : kt;
    const int bh = t == 0 ? bhq : bhk;
    for (int m = 0; m < 2; ++m) {
      const int w = m == 0 ? chunk : d % chunk;
      if ((m == 0 && d < chunk) || w == 0) continue;
      const CUresult r =
          make_map(&dst[t][m], ptrs[t], type, elem, d, seq, bh, w, rows);
      if (r != CUDA_SUCCESS) return kMapError + static_cast<int>(r);
    }
  }
  return 0;
}

}  // namespace
